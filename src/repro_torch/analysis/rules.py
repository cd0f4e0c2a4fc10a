# Port of src/repro/analysis/rules.py: the same eight rules over the port's
# tree.  Every scope names ``src/repro_torch/`` paths; ``movement-raw-backend``
# also allows ``launch/mesh.py`` (a StackedAxis hop is one K2 launch) and
# ``host-sync-in-hot-loop`` matches torch's sync idioms.
"""AST architecture lint rules behind a registry.

This extends the repo's registry pattern a fourth time: PR 1 registered
``CopyMechanism`` objects (pricing a copy), PR 3 registered movement
*backends* (performing a copy), PR 4 registered scheduling *policies*
(choosing a copy), and this module registers lint *rules* — proving that no
code path exists that could perform movement any other way.  Same contract
as the others: re-registering the same class (module reload) replaces
silently, a different class under a taken id raises.

Each rule guards one paper invariant (DESIGN.md Sec. 11 has the mapping):

* ``movement-raw-backend`` — all bulk movement flows through
  ``movement.plan()``; raw kernel/collective calls outside the backend
  registry would bypass the Table-1 cost accounting (LISA's point is that
  the *mechanism* is priced, not assumed).
* ``host-sync-in-hot-loop`` — the tick loop and wave dispatch never sync
  the device beyond the one sanctioned transfer per step: a stray
  ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``torch.cuda.synchronize()`` or ``float``/``int``/``bool`` of a tensor
  is a trip across the narrow channel mid-wave.
* ``wallclock-in-virtual-clock`` — scheduling runs on the virtual clock;
  wall-clock reads or unseeded RNG would make the priced schedules (and the
  CI-gated BENCH numbers) nondeterministic.
* ``json-nan`` — every JSON artifact is strict JSON (``allow_nan=False``):
  a NaN that serializes as a bare ``NaN`` literal poisons downstream
  schema checks silently.
* ``import-time-registration`` — backends/policies register at import time
  only; a call-site registration would make dispatch depend on execution
  order.
* ``unchecked-unpack`` — page payloads re-enter a cache only through the
  checksum-verified unpack leg; a raw ``unpack_into_slot`` call outside the
  movement substrate that never consults the sidecar is a silent-corruption
  hole (chaos runs gate on zero of these).
* ``unrefcounted-alias`` — serving code that drives the snapshot scatter
  (``_suspend`` / ``_suspend_many``) must consult the fork table's refcount
  API in the same function: a bare scatter into a row that forked sessions
  may alias overwrites every alias's bytes without a copy-on-write detach.
* ``unclosed-span`` — a ``begin_span`` with no ``end_span`` in the same
  function leaves the span open on its lane forever: every later span on
  that lane nests under it, and the trace's parent/child additivity
  contract silently breaks.  Use the ``span()`` context manager or close
  in the function that opened.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, Type

from repro_torch.analysis.findings import Finding

# every scope below is a path under the port
PORT = "src/repro_torch/"

_RULES: Dict[str, "LintRule"] = {}


def register_rule(cls: Type["LintRule"]) -> Type["LintRule"]:
    """Class decorator: register an instance under ``cls.id`` (the
    CopyMechanism/backend/policy registry contract)."""
    old = _RULES.get(cls.id)
    if old is not None and (type(old).__module__, type(old).__qualname__) != (
            cls.__module__, cls.__qualname__):
        raise ValueError(f"lint rule {cls.id!r} already registered by "
                         f"{type(old).__qualname__}")
    _RULES[cls.id] = cls()
    return cls


def get_rule(rule_id: str) -> "LintRule":
    try:
        return _RULES[rule_id]
    except KeyError:
        raise ValueError(f"unknown lint rule {rule_id!r} "
                         f"(known: {sorted(_RULES)})") from None


def rule_ids() -> Tuple[str, ...]:
    return tuple(sorted(_RULES))


def all_rules() -> Tuple["LintRule", ...]:
    return tuple(_RULES[k] for k in sorted(_RULES))


# ---------------------------------------------------------------------------
# shared AST plumbing
# ---------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """``np.asarray`` -> "np.asarray"; ``x.item`` -> "x.item"; None when the
    callee is not a plain name/attribute chain (e.g. a subscript)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _FuncStackVisitor(ast.NodeVisitor):
    """Generic walker tracking the enclosing-function name stack.  Decorator
    expressions are visited at the PARENT's depth (a module-level
    ``@register_backend(...)`` is import-time work, not function-body
    work)."""

    def __init__(self):
        self.stack: List[str] = []

    def _visit_func(self, node):
        for dec in node.decorator_list:
            self.visit(dec)
        self.stack.append(node.name)
        for child in node.body:
            self.visit(child)
        for default in list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]:
            self.visit(default)
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


def _call_bound_names(func: ast.AST) -> Set[str]:
    """Names that ``func``'s own body (not a nested function's) assigns
    from a call: ``x = f(...)``, ``a, b = f(...)``, ``x: T = f(...)``."""
    out: Set[str] = set()
    todo = list(func.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and isinstance(
                node.value, ast.Call):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
        todo.extend(ast.iter_child_nodes(node))
    return out


def _host_bound_names(func: ast.AST) -> Set[str]:
    """``func``'s parameters and the targets of its loops and
    comprehensions (not a nested function's): the names whose ``int()``
    is the host's normalisation of a value it was handed."""
    a = func.args
    out = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    out |= {x.arg for x in (a.vararg, a.kwarg) if x is not None}
    todo = list(func.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
            out |= {n.id for n in ast.walk(node.target)
                    if isinstance(n, ast.Name)}
        todo.extend(ast.iter_child_nodes(node))
    return out


def _root_name(node: ast.AST) -> Optional[str]:
    """The name an attribute/subscript chain starts from (``a`` of
    ``a.b[0].c``); None where it starts from a call or a literal."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class LintRule:
    """Base rule: ``applies_to`` scopes by repo-relative path, ``check``
    returns findings for one parsed module."""

    id: str = "base"
    doc: str = ""

    def applies_to(self, relpath: str) -> bool:
        raise NotImplementedError

    def check(self, tree: ast.Module, relpath: str,
              source: str) -> List[Finding]:
        raise NotImplementedError

    def finding(self, relpath: str, node: ast.AST, msg: str) -> Finding:
        return Finding(rule=self.id, path=relpath,
                       line=getattr(node, "lineno", 0), message=msg)


# ---------------------------------------------------------------------------
# rule 1: movement only via plan()
# ---------------------------------------------------------------------------

@register_rule
class RawBackendRule(LintRule):
    """Raw movement primitives may be CALLED only where the architecture
    says the bytes move: the kernel package (definitions and their plain
    versions), the RBM hop primitives, the one backend registry that
    executes ``MovementPlan`` legs, and the mesh axes, whose hop over a
    ``StackedAxis`` is one K2 launch.  Everywhere else movement must go
    through ``movement.plan()`` so it is priced."""

    id = "movement-raw-backend"
    doc = ("raw villa_gather/villa_scatter/rbm_copy/ppermute call outside "
           "the movement backend registry")

    RAW_CALLS = frozenset({"villa_gather", "villa_scatter", "rbm_copy",
                           "ppermute", "ppermute_start"})
    ALLOWED = (PORT + "kernels/",)
    ALLOWED_FILES = frozenset({PORT + "movement/backends.py",
                               PORT + "core/lisa/rbm.py",
                               PORT + "launch/mesh.py"})

    def applies_to(self, relpath: str) -> bool:
        return (relpath.startswith(PORT)
                and relpath not in self.ALLOWED_FILES
                and not any(relpath.startswith(p) for p in self.ALLOWED))

    def check(self, tree, relpath, source):
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name and name.split(".")[-1] in self.RAW_CALLS:
                findings.append(self.finding(
                    relpath, node,
                    f"raw movement call {name}() bypasses movement.plan(); "
                    f"route it through a registered backend so it is priced"))
        return findings


# ---------------------------------------------------------------------------
# rule 2: no host syncs in the tick loop / wave dispatch
# ---------------------------------------------------------------------------

@register_rule
class HostSyncRule(LintRule):
    """The serving hot path makes exactly ONE device→host transfer per
    decode step (``Engine.step_end``) plus the small sanctioned policy-tag
    reads the scheduler's cost scoring consults between dispatches.  Any
    other sync idiom in tick-loop or wave-dispatch code is a trip across
    the narrow channel the architecture exists to avoid.  The sanctioned
    readers are structural allowlist entries HERE (reviewed with the rule),
    never waiver-file lines — the waiver file stays empty.

    The idioms are torch's: ``.item()``, ``.cpu()``, ``.tolist()`` and
    ``.numpy()`` called without arguments, ``torch.cuda.synchronize()``,
    ``float()`` and ``np.asarray`` of a name or attribute (as the
    reference's rule), and ``int()``/``bool()`` of a call
    (``int(torch.argmax(t))``, ``bool(mask.any())``; a host builtin such
    as ``len`` aside), of a subscript or attribute (``int(t[i])``), or of
    a name that its function binds to what a call returned
    (``n = t.sum(); int(n)``).  An ``int()`` of a parameter or a loop
    variable, or of a subscript or attribute of one, is the host's own
    normalisation of a value it was handed (the reference's ``int(pos)`` of
    a session position, ``int(self.pos[slot])`` of the host's table), not
    a read of the device, and is left alone.  The rule is syntactic: a
    host-to-device copy (``torch.as_tensor``, ``to_device``) is not one of
    them."""

    id = "host-sync-in-hot-loop"
    doc = ("device sync (.item()/.cpu()/.tolist()/.numpy()/"
           "torch.cuda.synchronize/np.asarray/float-int-bool-on-a-tensor) "
           "inside tick-loop or wave-dispatch code")

    SCOPE = frozenset({
        PORT + "sched/scheduler.py",
        PORT + "sched/policy.py",
        PORT + "sched/queue.py",
        PORT + "serve/engine.py",
        PORT + "serve/cluster.py",
    })
    # the documented one-transfer-per-step contract and the policy-tag reads
    # (two more reads that the reference makes too, with an ``int()`` its
    # rule does not look at: ``submit``'s one read, the prompt's first
    # token, and ``scrub``, the end-of-run checksum audit off the tick loop)
    SANCTIONED: Dict[str, Set[str]] = {
        PORT + "serve/engine.py": {"step_end", "fast_resident_uids",
                                   "submit"},
        PORT + "serve/cluster.py": {"fast_occupancy", "_invalidate_fast",
                                    "scrub"},
    }
    # locals that hold a host value whatever the syntax says: the fault
    # injector's draw is a numpy array (``faults/spec.py::draw_movement``)
    HOST_VALUES: Dict[str, Set[str]] = {
        PORT + "serve/cluster.py": {"fault"},
    }
    HOST_BUILTINS = frozenset({"len", "min", "max", "sum", "abs", "round"})
    READS = frozenset({"item", "cpu", "tolist", "numpy"})
    SYNCHRONIZE = frozenset({"torch.cuda.synchronize", "cuda.synchronize"})
    ASARRAY = frozenset({"np.asarray", "numpy.asarray", "onp.asarray"})

    def applies_to(self, relpath: str) -> bool:
        return relpath in self.SCOPE

    def check(self, tree, relpath, source):
        rule, sanctioned = self, self.SANCTIONED.get(relpath, set())
        host_values = self.HOST_VALUES.get(relpath, set())
        findings: List[Finding] = []

        class V(_FuncStackVisitor):
            def __init__(self):
                super().__init__()
                self.bound: List[Set[str]] = [set()]
                self.host: List[Set[str]] = [set()]

            def _visit_func(self, node):
                self.bound.append(_call_bound_names(node))
                self.host.append(_host_bound_names(node) | host_values)
                super()._visit_func(node)
                self.bound.pop()
                self.host.pop()

            visit_FunctionDef = _visit_func
            visit_AsyncFunctionDef = _visit_func

            def visit_Call(self, node):
                if not (set(self.stack) & sanctioned):
                    msg = rule._sync_idiom(node, self.bound[-1],
                                           self.host[-1])
                    if msg:
                        findings.append(rule.finding(relpath, node, msg))
                self.generic_visit(node)

        V().visit(tree)
        return findings

    def _sync_idiom(self, node: ast.Call, call_bound: Set[str],
                    host: Set[str]) -> Optional[str]:
        name = dotted_name(node.func)
        if name is None:
            return None
        leaf = name.split(".")[-1]
        if leaf in self.READS and "." in name and not (node.args
                                                       or node.keywords):
            return (f"{name}() reads the device mid-tick (a device->host "
                    f"copy that waits for the stream)")
        if name in self.SYNCHRONIZE:
            return f"{name}() blocks the host on the device mid-tick"
        arg = node.args[0] if len(node.args) == 1 else None
        if isinstance(arg, ast.Name):
            on_value = arg.id in call_bound and arg.id not in host
        elif isinstance(arg, ast.Call):
            on_value = dotted_name(arg.func) not in self.HOST_BUILTINS
        elif isinstance(arg, (ast.Attribute, ast.Subscript)):
            on_value = _root_name(arg) not in host
        else:
            on_value = False
        on_buffer = isinstance(arg, (ast.Name, ast.Attribute))
        if name in self.ASARRAY and on_buffer:
            return (f"{name}() on a live buffer forces a device->host "
                    f"transfer; only the sanctioned step_end/policy-tag "
                    f"reads may sync")
        if name == "float" and on_buffer:
            return "float() on a live buffer syncs the device"
        if name in ("int", "bool") and on_value:
            return f"{name}() on a live buffer syncs the device"
        return None


# ---------------------------------------------------------------------------
# rule 3: virtual-clock modules stay deterministic
# ---------------------------------------------------------------------------

@register_rule
class WallClockRule(LintRule):
    """Everything under ``sched/`` runs on the scheduler's virtual clock
    (modeled ns): wall-clock reads or unseeded RNG there would decouple the
    priced schedule from the deterministic BENCH gates."""

    id = "wallclock-in-virtual-clock"
    doc = "wall-clock read or unseeded RNG in a virtual-clock module"

    # obs/ records MODELED time only — a wall-clock read there would stamp
    # host time onto the virtual timeline and break byte-stable traces;
    # core/dram/bank.py holds the refresher/bank-machine clock model whose
    # refresh windows must be a pure function of virtual time
    SCOPE_PREFIX = (PORT + "sched/", PORT + "obs/",
                    PORT + "core/dram/bank.py")
    WALL = frozenset({"time.time", "time.time_ns", "time.perf_counter",
                      "time.perf_counter_ns", "time.monotonic",
                      "time.monotonic_ns", "datetime.now",
                      "datetime.datetime.now", "datetime.utcnow"})

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith(self.SCOPE_PREFIX)

    def check(self, tree, relpath, source):
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            if name in self.WALL:
                findings.append(self.finding(
                    relpath, node,
                    f"{name}() reads the wall clock inside the virtual-"
                    f"clock domain; charge modeled ns instead"))
            elif name.startswith("random."):
                findings.append(self.finding(
                    relpath, node,
                    f"{name}() uses the unseeded global RNG; thread a "
                    f"seeded np.random.default_rng(seed) through instead"))
            elif (name.endswith(".random.default_rng")
                  or name == "default_rng") and not (node.args
                                                     or node.keywords):
                findings.append(self.finding(
                    relpath, node,
                    "default_rng() without a seed is entropy-seeded; pass "
                    "the workload seed explicitly"))
            elif (name.split(".")[0] in ("np", "numpy")
                  and ".random." in name
                  and not name.endswith("default_rng")):
                findings.append(self.finding(
                    relpath, node,
                    f"{name}() draws from the global numpy RNG; use a "
                    f"seeded Generator"))
        return findings


# ---------------------------------------------------------------------------
# rule 4: strict JSON artifacts
# ---------------------------------------------------------------------------

@register_rule
class JsonNanRule(LintRule):
    """``json.dump``/``dumps`` must pass ``allow_nan=False``: Python's
    default emits bare ``NaN``/``Infinity`` literals, which are not JSON —
    a NaN metric must fail at WRITE time, not poison a consumer later.
    (``repro_torch.sched.metrics`` reports empty classes as None for exactly this
    reason.)"""

    id = "json-nan"
    doc = "json.dump/json.dumps without allow_nan=False"

    def applies_to(self, relpath: str) -> bool:
        return True

    def check(self, tree, relpath, source):
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name not in ("json.dump", "json.dumps"):
                continue
            ok = any(kw.arg == "allow_nan"
                     and isinstance(kw.value, ast.Constant)
                     and kw.value.value is False for kw in node.keywords)
            if not ok:
                findings.append(self.finding(
                    relpath, node,
                    f"{name}() without allow_nan=False writes non-strict "
                    f"JSON (bare NaN/Infinity literals)"))
        return findings


# ---------------------------------------------------------------------------
# rule 5: registries are import-time only
# ---------------------------------------------------------------------------

@register_rule
class ImportTimeRegistrationRule(LintRule):
    """Backend/policy/rule registration must complete at import time — a
    registration inside a function body makes lookup depend on whether and
    when that function ran (the reload-safe registry contract assumes the
    module body IS the registration transaction)."""

    id = "import-time-registration"
    doc = "register_backend/register_policy/register_rule inside a function"

    REGISTRARS = frozenset({"register_backend", "register_policy",
                            "register_rule", "register_mechanism",
                            "register_fault"})

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith(PORT)

    def check(self, tree, relpath, source):
        rule = self
        findings: List[Finding] = []

        class V(_FuncStackVisitor):
            def visit_Call(self, node):
                name = dotted_name(node.func)
                if (name and name.split(".")[-1] in rule.REGISTRARS
                        and self.stack):
                    findings.append(rule.finding(
                        relpath, node,
                        f"{name}() called inside "
                        f"{'.'.join(self.stack)}(); registries are "
                        f"import-time only"))
                self.generic_visit(node)

        V().visit(tree)
        return findings


# ---------------------------------------------------------------------------
# rule 6: unpacked pages must be checksum-verified
# ---------------------------------------------------------------------------

@register_rule
class UncheckedUnpackRule(LintRule):
    """Outside the movement substrate (whose unpack backend verifies the
    sidecar itself), a function that calls ``unpack_into_slot`` directly
    must also consult the checksum surface — ``page_checksums`` /
    ``verify_pages``, or pass the ``sums=`` operand through an
    ``execute(...)`` env.  A bare unpack re-materializes page bytes into a
    live cache with no way to notice in-flight or at-rest corruption: the
    exact hole the chaos bench's zero-silent-corruption gate closes."""

    id = "unchecked-unpack"
    doc = ("unpack_into_slot call outside movement/ in a function that "
           "never consults the checksum sidecar")

    SCOPE_EXCLUDE = PORT + "movement/"
    VERIFIERS = frozenset({"page_checksums", "verify_pages"})

    def applies_to(self, relpath: str) -> bool:
        return (relpath.startswith(PORT)
                and not relpath.startswith(self.SCOPE_EXCLUDE))

    def check(self, tree, relpath, source):
        rule = self
        findings: List[Finding] = []

        class V(_FuncStackVisitor):
            def __init__(self):
                super().__init__()
                self.unpacks: List[Tuple[Tuple[str, ...], ast.Call]] = []
                self.verified: Set[Tuple[str, ...]] = set()

            def visit_Call(self, node):
                name = dotted_name(node.func)
                leaf = name.split(".")[-1] if name else ""
                key = tuple(self.stack)
                if leaf == "unpack_into_slot":
                    self.unpacks.append((key, node))
                elif leaf in rule.VERIFIERS or any(
                        kw.arg == "sums" for kw in node.keywords):
                    self.verified.add(key)
                self.generic_visit(node)

        v = V()
        v.visit(tree)
        for key, node in v.unpacks:
            if key not in v.verified:
                findings.append(rule.finding(
                    relpath, node,
                    "unpack_into_slot() without a checksum verify in the "
                    "same function; route through the movement unpack leg "
                    "(which verifies the sidecar) or call verify_pages()"))
        return findings


# ---------------------------------------------------------------------------
# rule 7: snapshot scatters respect the fork table's refcounts
# ---------------------------------------------------------------------------

@register_rule
class UnrefcountedAliasRule(LintRule):
    """Forked sessions alias ONE physical store row (``repro_torch.fork``); the
    row is written by the ``_suspend`` / ``_suspend_many`` scatter
    dispatches.  A serving function that drives that scatter — calling
    the dispatch directly or handing it to a wrapper like ``_quiet`` —
    without touching the fork table's refcount API (``write_break`` /
    ``bind`` / ``fork_child`` / ``release``) in the same function would
    overwrite a possibly-shared row with one writer's bytes and silently
    corrupt every other alias: the copy-on-write detach MUST gate the
    scatter.  (Benchmarks drive ``eng._suspend`` raw for A/B timing — the
    scope is the serving and fork packages, where the alias ledger is
    live.)"""

    id = "unrefcounted-alias"
    doc = ("_suspend/_suspend_many scatter in serving code with no fork-"
           "table refcount call (write_break/bind/fork_child/release) in "
           "the same function")

    SCOPE_PREFIXES = (PORT + "serve/", PORT + "fork/")
    MUTATORS = frozenset({"_suspend", "_suspend_many"})
    VERIFIERS = frozenset({"write_break", "bind", "fork_child", "release"})

    def applies_to(self, relpath: str) -> bool:
        return any(relpath.startswith(p) for p in self.SCOPE_PREFIXES)

    def check(self, tree, relpath, source):
        rule = self
        findings: List[Finding] = []

        class V(_FuncStackVisitor):
            def __init__(self):
                super().__init__()
                self.scatters: List[Tuple[Tuple[str, ...], ast.Call]] = []
                self.verified: Set[Tuple[str, ...]] = set()

            def visit_Call(self, node):
                key = tuple(self.stack)
                name = dotted_name(node.func)
                leaf = name.split(".")[-1] if name else ""
                if leaf in rule.MUTATORS:
                    self.scatters.append((key, node))
                else:
                    # the dispatch handed to a wrapper: _quiet(self._suspend,
                    # ...) drives the same scatter
                    for a in node.args:
                        an = dotted_name(a)
                        if an and an.split(".")[-1] in rule.MUTATORS:
                            self.scatters.append((key, node))
                            break
                if leaf in rule.VERIFIERS:
                    self.verified.add(key)
                self.generic_visit(node)

        v = V()
        v.visit(tree)
        for key, node in v.scatters:
            if key not in v.verified:
                findings.append(rule.finding(
                    relpath, node,
                    "snapshot scatter without a fork-table refcount call in "
                    "the same function; a forked alias may share this row — "
                    "CoW-detach via write_break() before writing"))
        return findings


# ---------------------------------------------------------------------------
# rule 8: tracer spans close where they open
# ---------------------------------------------------------------------------

@register_rule
class UnclosedSpanRule(LintRule):
    """A span opened with ``begin_span`` and never closed stays on its
    lane's stack forever: every later span on that lane silently nests
    under it, its duration covers the rest of the run, and the trace's
    parent/child additivity contract (tests/test_obs.py) breaks without an
    error.  So the pairing is STRUCTURAL, like ``unrefcounted-alias``'s
    scatter/refcount pairing: a function that calls ``begin_span`` must
    also call ``end_span`` (on any span) in the same function — or use the
    ``span()`` context manager, which cannot leak.  ``emit`` / ``instant``
    / ``move_span`` are self-closing and need no pairing."""

    id = "unclosed-span"
    doc = ("begin_span with no end_span in the same function; use the "
           "span() context manager or close where you open")

    OPENER = "begin_span"
    CLOSER = "end_span"

    def applies_to(self, relpath: str) -> bool:
        # everywhere the tracer may be driven; obs/tracer.py itself defines
        # the pairing (span()/emit/move_span all open AND close)
        return relpath.startswith(PORT) or \
            relpath.startswith("benchmarks/")

    def check(self, tree, relpath, source):
        rule = self
        findings: List[Finding] = []

        class V(_FuncStackVisitor):
            def __init__(self):
                super().__init__()
                self.opens: List[Tuple[Tuple[str, ...], ast.Call]] = []
                self.closed: Set[Tuple[str, ...]] = set()

            def visit_Call(self, node):
                name = dotted_name(node.func)
                leaf = name.split(".")[-1] if name else ""
                key = tuple(self.stack)
                if leaf == rule.OPENER:
                    self.opens.append((key, node))
                elif leaf == rule.CLOSER:
                    self.closed.add(key)
                self.generic_visit(node)

        v = V()
        v.visit(tree)
        for key, node in v.opens:
            if key not in v.closed:
                findings.append(rule.finding(
                    relpath, node,
                    "begin_span() with no end_span() in the same function "
                    "leaves the span open on its lane (all later spans nest "
                    "under it); use tracer.span() or close here"))
        return findings
