"""skylint rules: the repo's load-bearing invariants, machine-checked.

Each rule is a :class:`~repro_torch.analysis.engine.Rule` registered with
``@register``. Rules key off root-relative paths (``ctx.under(...)``), so
the self-tests exercise them against synthetic mini-trees under
``tmp_path`` that mirror the real layout.

| id     | invariant                                                     |
|--------|---------------------------------------------------------------|
| SKY001 | determinism: seeded RNG only, no wall-clock in sim/planner    |
| SKY002 | cache safety: LP structures built only by milp.py factories   |
| SKY003 | frozen grids: Topology arrays mutate via with_tput only       |
| SKY004 | sim parity: the three engine entry points stay signature-     |
|        | pinned behind sim.simulate and dispatch every event class     |
| SKY005 | report protocol: *Report classes expose kind/to_dict/summary  |
| SKY006 | deprecated API: first-party code uses Planner.plan(PlanSpec)  |
| SKY007 | shared state: registered counters + lock-guarded workers only |
| SKY008 | format drift: 88-col lines, double quotes, no tabs            |
| SKY009 | counter discipline: obs.metrics instruments, no `global`      |
| SKY010 | deprecated sim API: first-party code uses sim.simulate        |
"""

from __future__ import annotations

import ast

from .engine import Context, Finding, Rule, register


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _comma(items) -> str:
    """``", ".join(items)``: a call that keeps the quotes out of f-string
    fields, which SKY008 reads as single-quoted strings on Python 3.12."""
    return ", ".join(items)


def _tail(node: ast.AST) -> str | None:
    """The final attribute/name of a call target (``c`` for ``a.b.c``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


# --------------------------------------------------------------------- SKY001
# Everything the planner, simulators and calibration plane compute must be a
# pure function of (topology, spec, seed): seeds flow in as parameters and
# wall-clock never leaks into simulated time. time.monotonic()/perf_counter()
# stay legal — they measure the measurement, not the simulation.
_WALL_CLOCK = {
    "time.time",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "date.today", "datetime.date.today",
}
# Seeded construction stays legal on both RNG front-ends.
_RANDOM_OK = {"Random", "SystemRandom"}
_NP_RANDOM_OK = {"default_rng", "Generator", "PCG64", "SeedSequence"}
_DETERMINISTIC_DIRS = (
    "src/repro/transfer", "src/repro/core", "src/repro/calibrate",
    "src/repro/ckpt",
)


@register
class DeterminismRule(Rule):
    id = "SKY001"
    severity = "error"
    description = (
        "seeded randomness only: no unseeded default_rng(), no bare "
        "random.*/np.random.* module calls; no wall-clock reads inside "
        "sim/planner/calibrate code"
    )
    hint = "take a seed parameter and draw from np.random.default_rng(seed)"

    def visit(self, tree: ast.Module, ctx: Context) -> list[Finding]:
        out = []
        in_sim_code = ctx.under(*_DETERMINISTIC_DIRS)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            tail = _tail(node.func)
            if tail == "default_rng" and not node.args and not node.keywords:
                out.append(ctx.finding(
                    self, node,
                    "unseeded default_rng() — entropy from the OS breaks "
                    "replayability",
                ))
            elif dotted is not None and dotted.startswith("random."):
                fn = dotted.split(".", 1)[1]
                if "." not in fn and fn not in _RANDOM_OK:
                    out.append(ctx.finding(
                        self, node,
                        f"bare {dotted}() draws from the global random "
                        "module state",
                        hint="use random.Random(seed) or a passed-in rng",
                    ))
            elif dotted is not None and (
                dotted.startswith("np.random.")
                or dotted.startswith("numpy.random.")
            ):
                fn = dotted.split("random.", 1)[1]
                if "." not in fn and fn not in _NP_RANDOM_OK:
                    out.append(ctx.finding(
                        self, node,
                        f"{dotted}() uses numpy's legacy global RNG state",
                    ))
            elif in_sim_code and dotted in _WALL_CLOCK:
                out.append(ctx.finding(
                    self, node,
                    f"wall-clock read {dotted}() inside deterministic "
                    "sim/planner code",
                    hint="pass timestamps in as parameters; "
                    "time.monotonic()/perf_counter() are fine for "
                    "measuring real elapsed time",
                ))
        return out


# --------------------------------------------------------------------- SKY002
@register
class CacheSafetyRule(Rule):
    id = "SKY002"
    severity = "error"
    description = (
        "LPStructure/MulticastLPStructure are built only by core/milp.py's "
        "factories — re-plans must ride cached structures via scale cuts"
    )
    hint = "call milp.structure(...) / milp.multicast_structure(...)"

    FACTORY_HOME = "src/repro/core/milp.py"
    CLASSES = {"LPStructure", "MulticastLPStructure"}

    def visit(self, tree: ast.Module, ctx: Context) -> list[Finding]:
        if ctx.current.relpath == self.FACTORY_HOME:
            return []
        out = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and _tail(node.func) in self.CLASSES:
                out.append(ctx.finding(
                    self, node,
                    f"direct {_tail(node.func)}(...) construction bypasses "
                    "the structure cache (N_STRUCT_BUILDS)",
                ))
        return out


# --------------------------------------------------------------------- SKY003
@register
class FrozenGridRule(Rule):
    id = "SKY003"
    severity = "error"
    description = (
        "no subscript assignment into Topology grid arrays — the grids "
        "are frozen; mutation routes through Topology.with_tput"
    )
    hint = "build a modified copy with top.with_tput(...)"

    GRIDS = {
        "tput", "price_egress", "price_vm", "limit_ingress",
        "limit_egress", "rtt_ms",
    }

    def _grid_store(self, target: ast.AST) -> ast.AST | None:
        if (
            isinstance(target, ast.Subscript)
            and isinstance(target.value, ast.Attribute)
            and target.value.attr in self.GRIDS
        ):
            return target
        return None

    def visit(self, tree: ast.Module, ctx: Context) -> list[Finding]:
        out = []
        for node in ast.walk(tree):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                hit = self._grid_store(t)
                if hit is not None:
                    out.append(ctx.finding(
                        self, node,
                        f"in-place write to frozen grid "
                        f".{t.value.attr}[...]",
                    ))
        return out


# --------------------------------------------------------------------- SKY004
def _func(tree: ast.Module, name: str) -> ast.FunctionDef | None:
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _signature(fn: ast.FunctionDef) -> list[tuple[str, str | None]]:
    """(name, default-source) pairs across every parameter kind."""
    a = fn.args
    sig: list[tuple[str, str | None]] = []
    pos = list(a.posonlyargs) + list(a.args)
    pos_defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    for arg, d in zip(pos, pos_defaults):
        sig.append((arg.arg, None if d is None else ast.unparse(d)))
    if a.vararg:
        sig.append(("*" + a.vararg.arg, None))
    elif a.kwonlyargs:
        sig.append(("*", None))
    for arg, d in zip(a.kwonlyargs, a.kw_defaults):
        sig.append((arg.arg, None if d is None else ast.unparse(d)))
    if a.kwarg:
        sig.append(("**" + a.kwarg.arg, None))
    return sig


def _dispatch_names(root: ast.AST) -> set[str]:
    """Names a sim dispatches on: the second argument of every
    ``isinstance(ev, ...)`` call under ``root`` (tuples contribute each
    member). ``root`` may be a whole module — since the jax engine splits
    event application out of its entry point into a host helper, parity is
    checked module-wide, not per-function."""
    names: set[str] = set()
    for node in ast.walk(root):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "isinstance"
            and len(node.args) == 2
        ):
            continue
        spec = node.args[1]
        members = spec.elts if isinstance(spec, ast.Tuple) else [spec]
        for m in members:
            t = _tail(m)
            if t is not None:
                names.add(t)
    return names


@register
class SimParityRule(Rule):
    id = "SKY004"
    severity = "error"
    description = (
        "the three sim engines (flowsim / flowsim_ref / flowsim_jax) keep "
        "signature-pinned entry points behind transfer.sim.simulate, and "
        "every event class in events.py is dispatched by all three"
    )
    hint = "mirror the change in the sibling engines and the dispatcher"

    ANCHOR = "src/repro/transfer/flowsim.py"
    REF = "src/repro/transfer/flowsim_ref.py"
    JAX = "src/repro/transfer/flowsim_jax.py"
    DISPATCHER = "src/repro/transfer/sim.py"
    EVENTS = "src/repro/transfer/events.py"

    def visit(self, tree: ast.Module, ctx: Context) -> list[Finding]:
        if ctx.current.relpath != self.ANCHOR:
            return []
        trees: dict[str, ast.Module] = {self.ANCHOR: tree}
        absent = []
        for rel in (self.REF, self.JAX, self.DISPATCHER):
            sf = ctx.file(rel)
            if sf is None or sf.tree is None:
                absent.append(rel)
            else:
                trees[rel] = sf.tree
        if absent:
            return [ctx.finding(
                self, 1, "cannot check sim parity: "
                f"{_comma(absent)} not in the scanned tree",
                hint="scan src/ as a whole",
            )]
        ev_sf = ctx.file(self.EVENTS)
        out = []
        fast = _func(tree, "simulate_multi")
        ref = _func(trees[self.REF], "simulate_multi_reference")
        jx = _func(trees[self.JAX], "simulate_multi_jax")
        disp_fn = _func(trees[self.DISPATCHER], "simulate")
        lost = [name for name, fn in (
            ("simulate_multi", fast),
            ("simulate_multi_reference", ref),
            ("simulate_multi_jax", jx),
            ("sim.simulate", disp_fn),
        ) if fn is None]
        if lost:
            return [ctx.finding(self, 1, f"{_comma(lost)} not found")]

        sig_fast, sig_ref = _signature(fast), _signature(ref)
        if sig_fast != sig_ref:
            out.append(ctx.finding(
                self, fast,
                "simulate_multi and simulate_multi_reference signatures "
                f"differ: {sig_fast} vs {sig_ref}",
            ))
        # The jax entry extends the pinned surface with private knobs only
        # (e.g. _rate_solver) — anything public belongs on SimConfig.
        sig_jax = _signature(jx)
        extras = sig_jax[len(sig_fast):]
        if sig_jax[:len(sig_fast)] != sig_fast or not all(
            name.lstrip("*").startswith("_") for name, _ in extras
        ):
            out.append(ctx.finding(
                self, fast,
                "simulate_multi_jax must extend the pinned legacy "
                f"signature with private knobs only: {sig_jax} vs "
                f"{sig_fast}",
            ))
        # The dispatcher is the legacy surface plus a trailing engine knob.
        sig_disp = _signature(disp_fn)
        if sig_disp[:-1] != sig_fast or sig_disp[-1] != (
            "engine", "'soa'",
        ):
            out.append(ctx.finding(
                self, fast,
                "sim.simulate must take the pinned legacy signature plus "
                f"a trailing engine=\"soa\": {sig_disp} vs {sig_fast}",
            ))

        # Expand RATE_EVENTS through events.py so dispatching on the tuple
        # covers its members.
        groups: dict[str, set[str]] = {}
        universe: set[str] = set()
        ev_classes: set[str] = set()
        if ev_sf is not None and ev_sf.tree is not None:
            for node in ev_sf.tree.body:
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Tuple
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            groups[t.id] = {
                                _tail(e) for e in node.value.elts
                                if _tail(e) is not None
                            }
                if isinstance(node, ast.ClassDef):
                    ev_classes.add(node.name)
                    fields = {
                        s.target.id for s in node.body
                        if isinstance(s, ast.AnnAssign)
                        and isinstance(s.target, ast.Name)
                    }
                    # event classes are the frozen dataclasses stamped with
                    # an event time; result/job records carry no t_s
                    if "t_s" in fields:
                        universe.add(node.name)

        def expand(names: set[str]) -> set[str]:
            flat = set()
            for n in names:
                flat |= groups.get(n, {n})
            return flat

        engines = (
            ("flowsim", self.ANCHOR),
            ("flowsim_ref", self.REF),
            ("flowsim_jax", self.JAX),
        )
        disp = {
            side: expand(_dispatch_names(trees[rel]))
            for side, rel in engines
        }
        for side, _ in engines:
            if "int" not in disp[side]:
                out.append(ctx.finding(
                    self, fast,
                    f"{side} event loop has no job-arrival (int) dispatch "
                    "branch",
                ))
        for ev in sorted(universe):
            for side, _ in engines:
                if ev not in disp[side]:
                    out.append(ctx.finding(
                        self, fast,
                        f"event class {ev} from events.py has no dispatch "
                        f"branch in {side}",
                    ))
        # An events.py class outside the t_s universe dispatched by one
        # engine must be dispatched by all (isinstance checks on foreign
        # classes like MulticastPlan are not parity-relevant).
        union = set().union(*disp.values())
        for ev in sorted((union & ev_classes) - universe):
            behind = [s for s, _ in engines if ev not in disp[s]]
            if behind:
                out.append(ctx.finding(
                    self, fast,
                    f"{ev} is dispatched by some engines but not by "
                    f"{_comma(behind)}",
                ))
        return out


# --------------------------------------------------------------------- SKY005
@register
class ReportProtocolRule(Rule):
    id = "SKY005"
    severity = "error"
    description = (
        "every *Report class in the transfer plane exposes the report "
        "protocol: kind, to_dict, summary"
    )
    hint = (
        "subclass transfer.reports.Report, set kind and implement "
        "_payload()/_summary_keys"
    )

    SCOPE = (
        "src/repro/transfer", "src/repro/core", "src/repro/calibrate",
        "src/repro/ckpt",
    )
    ROOT = "Report"  # the mixin itself is exempt

    def visit(self, tree: ast.Module, ctx: Context) -> list[Finding]:
        if not ctx.under(*self.SCOPE):
            return []
        out = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not node.name.endswith("Report") or node.name == self.ROOT:
                continue
            full = ctx.mro_names(node.name)
            own = ctx.mro_names(node.name, exclude=(self.ROOT,))
            missing = [m for m in ("to_dict", "summary") if m not in full]
            # the mixin's to_dict/summary only produce real output when the
            # subclass chain supplies kind and _payload itself
            if "kind" not in own:
                missing.append("kind")
            if "to_dict" not in own and "_payload" not in own:
                missing.append("_payload")
            if missing:
                out.append(ctx.finding(
                    self, node,
                    f"{node.name} does not satisfy the report protocol "
                    f"(missing: {_comma(sorted(set(missing)))})",
                ))
        return out


# --------------------------------------------------------------------- SKY006
@register
class DeprecatedApiRule(Rule):
    id = "SKY006"
    severity = "error"
    description = (
        "first-party code calls Planner.plan(PlanSpec(...)), not the "
        "deprecated plan_* shims (tests exempt: they pin shim equality)"
    )
    hint = "planner.plan(PlanSpec(objective=..., src=..., dst=...))"

    SHIMS = {
        "max_throughput", "max_multicast_throughput",
        "plan_cost_min", "plan_tput_max",
        "plan_multicast_cost_min", "plan_multicast_tput_max",
        "pareto_frontier", "pareto_frontier_fast",
    }
    SCOPE = ("src", "benchmarks", "examples")
    SHIM_HOME = "src/repro/core/planner.py"  # the shims' own definitions

    def visit(self, tree: ast.Module, ctx: Context) -> list[Finding]:
        if not ctx.under(*self.SCOPE):
            return []
        if ctx.current.relpath == self.SHIM_HOME:
            return []
        out = []
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in self.SHIMS
            ):
                out.append(ctx.finding(
                    self, node,
                    f".{node.func.attr}(...) is a deprecated shim",
                ))
        return out


# --------------------------------------------------------------------- SKY007
def _bound_names(fn: ast.FunctionDef) -> set[str]:
    """Names the function binds locally (params + any store target)."""
    a = fn.args
    bound = {p.arg for p in (
        list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
    )}
    if a.vararg:
        bound.add(a.vararg.arg)
    if a.kwarg:
        bound.add(a.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)) and node is not fn:
            bound.add(node.name)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            bound -= set(node.names)
    return bound


class _LockWalk(ast.NodeVisitor):
    """Find subscript stores on free names outside with-lock blocks."""

    def __init__(self, free: set[str]):
        self.free = free
        self.in_lock = 0
        self.hits: list[ast.AST] = []

    def visit_With(self, node: ast.With):
        locked = any(
            "lock" in ast.unparse(item.context_expr).lower()
            for item in node.items
        )
        if locked:
            self.in_lock += 1
        self.generic_visit(node)
        if locked:
            self.in_lock -= 1

    def _check(self, target: ast.AST, node: ast.AST):
        if self.in_lock:
            return
        if isinstance(target, ast.Subscript):
            base = target.value
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Name) and base.id in self.free:
                self.hits.append(node)

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._check(t, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._check(node.target, node)
        self.generic_visit(node)


@register
class SharedStateRule(Rule):
    id = "SKY007"
    severity = "error"
    description = (
        "module-level mutable state in transfer//calibrate/ must live in "
        "the obs.metrics registry; gateway thread workers write shared "
        "containers only under the lock"
    )
    hint = "register an obs.metrics instrument, or move the write under "\
           "`with lock:`"

    MODULE_SCOPE = ("src/repro/transfer", "src/repro/calibrate")
    # The one sanctioned module-level mutable: the API surface. Counters
    # moved into the obs.metrics registry (SKY009 polices the rest).
    REGISTERED = {"__all__"}
    MUTABLE_CALLS = {
        "dict", "list", "set", "defaultdict", "deque", "Counter",
        "OrderedDict",
    }

    def visit(self, tree: ast.Module, ctx: Context) -> list[Finding]:
        out = []
        if ctx.under(*self.MODULE_SCOPE):
            out += self._module_state(tree, ctx)
        if ctx.current.relpath.startswith("src/repro/transfer/gateway"):
            out += self._worker_closures(tree, ctx)
        return out

    def _is_mutable(self, value: ast.AST) -> bool:
        if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                              ast.SetComp, ast.DictComp)):
            return True
        return (
            isinstance(value, ast.Call)
            and _tail(value.func) in self.MUTABLE_CALLS
        )

    def _module_state(self, tree: ast.Module, ctx: Context) -> list[Finding]:
        out = []
        for node in tree.body:
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            if not self._is_mutable(value):
                continue
            for t in targets:
                if isinstance(t, ast.Name) and t.id not in self.REGISTERED:
                    out.append(ctx.finding(
                        self, node,
                        f"module-level mutable {t.id!r} is unregistered "
                        "shared state",
                    ))
        return out

    def _worker_closures(self, tree: ast.Module, ctx: Context) -> list:
        out = []
        for top in tree.body:
            if not isinstance(top, ast.FunctionDef):
                continue
            # which nested functions run on threads?
            targets: set[str] = set()
            for node in ast.walk(top):
                if not (isinstance(node, ast.Call)
                        and _tail(node.func) == "Thread"):
                    continue
                for kw in node.keywords:
                    if kw.arg == "target" and isinstance(kw.value, ast.Name):
                        targets.add(kw.value.id)
            if not targets:
                continue
            for node in ast.walk(top):
                if not (isinstance(node, ast.FunctionDef)
                        and node.name in targets and node is not top):
                    continue
                free = _bound_names(top) - _bound_names(node)
                walk = _LockWalk(free)
                for st in node.body:
                    walk.visit(st)
                for hit in walk.hits:
                    out.append(ctx.finding(
                        self, hit,
                        f"thread worker {node.name!r} writes a shared "
                        "container outside the lock",
                    ))
        return out


# --------------------------------------------------------------------- SKY008
@register
class FormatDriftRule(Rule):
    id = "SKY008"
    severity = "warning"
    description = (
        "format drift: lines stay within 88 columns, strings are "
        "double-quoted, indentation is spaces (stand-in for the absent "
        "ruff-format binary)"
    )
    hint = "wrap the line / flip the quotes, matching `ruff format` output"

    MAX_COLS = 88

    def visit(self, tree: ast.Module, ctx: Context) -> list[Finding]:
        import io
        import tokenize

        out = []
        sf = ctx.current
        for i, line in enumerate(sf.lines, start=1):
            if len(line) > self.MAX_COLS:
                out.append(ctx.finding(
                    self, i, f"line is {len(line)} columns (max "
                    f"{self.MAX_COLS})",
                ))
            body = line[:len(line) - len(line.lstrip())]
            if "\t" in body:
                out.append(ctx.finding(self, i, "tab indentation"))
        try:
            toks = tokenize.generate_tokens(io.StringIO(sf.source).readline)
            for tok in toks:
                if tok.type != tokenize.STRING:
                    continue
                text = tok.string
                prefix_len = len(text) - len(text.lstrip("rbufRBUF"))
                prefix = text[:prefix_len].lower()
                body = text[prefix_len:]
                if "r" in prefix and '"' in text:
                    continue  # raw strings keep their author's quoting
                if body.startswith("'") and '"' not in body:
                    out.append(ctx.finding(
                        self, tok.start[0],
                        "single-quoted string (double quotes are the "
                        "repo style)",
                    ))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass
        return out


# --------------------------------------------------------------------- SKY009
@register
class CounterDisciplineRule(Rule):
    id = "SKY009"
    severity = "error"
    description = (
        "counters and gauges in transfer//calibrate//core/ go through "
        "the obs.metrics registry: no `global` rebinding of module "
        "state, no ALL-CAPS zero-seeded module counters"
    )
    hint = "hold a REGISTRY.counter(...)/gauge(...) from repro.obs.metrics"

    SCOPE = ("src/repro/transfer", "src/repro/calibrate", "src/repro/core")

    def visit(self, tree: ast.Module, ctx: Context) -> list[Finding]:
        out: list[Finding] = []
        if not ctx.under(*self.SCOPE):
            return out
        for node in ast.walk(tree):
            if isinstance(node, ast.Global):
                out.append(ctx.finding(
                    self, node,
                    "global statement rebinds module state "
                    f"({_comma(node.names)}) — ad-hoc process "
                    "counters belong in the obs.metrics registry",
                ))
        for node in tree.body:
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            # an ALL-CAPS name seeded with a literal zero is the ad-hoc
            # counter idiom (`N_FOO = 0` bumped from function bodies) —
            # nonzero literals are genuine constants and stay legal
            if not (
                isinstance(value, ast.Constant)
                and type(value.value) in (int, float)
                and value.value == 0
            ):
                continue
            for t in targets:
                if (
                    isinstance(t, ast.Name)
                    and len(t.id) > 1
                    and t.id.isupper()
                ):
                    out.append(ctx.finding(
                        self, node,
                        f"zero-seeded module counter {t.id!r} — register "
                        "it as an obs.metrics instrument",
                    ))
        return out


# --------------------------------------------------------------------- SKY010
@register
class DeprecatedSimEntryRule(Rule):
    id = "SKY010"
    severity = "error"
    description = (
        "first-party code simulates through transfer.sim.simulate with an "
        "engine selector, not the per-engine entry points (tests exempt: "
        "they pin shim equality)"
    )
    hint = 'transfer.sim.simulate(jobs, faults, engine="soa"|"ref"|"jax")'

    ENTRIES = {
        "simulate_multi", "simulate_multi_reference", "simulate_multi_jax",
        "_simulate_multi_impl", "_simulate_multi_reference_impl",
    }
    SCOPE = ("src", "benchmarks", "examples")
    # the engines' own homes and the dispatcher that fronts them
    HOMES = {
        "src/repro/transfer/flowsim.py",
        "src/repro/transfer/flowsim_ref.py",
        "src/repro/transfer/flowsim_jax.py",
        "src/repro/transfer/sim.py",
    }

    def visit(self, tree: ast.Module, ctx: Context) -> list[Finding]:
        if not ctx.under(*self.SCOPE):
            return []
        if ctx.current.relpath in self.HOMES:
            return []
        out = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            t = _tail(node.func)
            if t in self.ENTRIES:
                out.append(ctx.finding(
                    self, node,
                    f"{t}(...) bypasses the sim-engine dispatcher",
                ))
        return out
