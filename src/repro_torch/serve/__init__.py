"""Serving: the continuous-batching engine and its paged session store
(ports of src/repro/serve/engine.py and paged_store.py)."""
