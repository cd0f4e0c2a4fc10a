"""Serving: the continuous-batching engine, its paged session store and the
replica fleet (ports of src/repro/serve/engine.py, paged_store.py and
cluster.py)."""
