"""Rule ``jit-boundary`` — the ladder catches outside the launch, the launch
path stays pure.

The reference's contract (ROADMAP, "hardened execution"): failures are
caught outside ``jax.jit`` so a failed trace is never cached, and traced
code never host-syncs. The port has no traces; its counterpart of traced
code is code that launches a hand-written kernel:

  * a *kernel wrapper* is a function of ``kernels/`` that launches a kernel,
    directly through ``_build.launch`` or ``_build.load``, or through
    another wrapper that it calls by a same-module or imported name
    (``spgemm_lp`` reaches ``launch_ell``, ``lp_reuse_arrays`` reaches
    ``segsum_reuse.launch_replay``);
  * the *traced set* is the wrappers plus the same-module helpers they call
    (as ``traced_functions`` closes the reference's set), without
    ``kernels/_build.py`` (the launcher, as ``pallas_call`` is not linted),
    ``kernels/ops.py`` (the dispatch layer, where the ladder belongs; the
    reference's is untraced too) and the CPU-only plain versions and
    oracles, left out by name (``*_plain``, ``*_ref``);
  * functions handed to ``torch.compile`` or
    ``torch.cuda.make_graphed_callables`` and those called inside a
    ``with torch.cuda.graph(...)`` block are traced too, beside the
    reference's ``jit`` and ``pallas_call``.

Sub-checks:

  * ``jit-boundary.try-in-traced`` — a ``try`` statement inside a traced
    function. Exceptions must reach the dispatch site's ladder
    (``runtime/ladder.walk``) as they are.
  * ``jit-boundary.host-sync`` — in jit/Pallas-traced code, the reference's
    ``np.asarray`` / ``.item()`` / ``.block_until_ready()`` / ``float(...)``
    / ``.tolist()``; in the port's traced set, a call that waits for the
    device: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.synchronize()``, ``torch.cuda.synchronize``, ``np.asarray``, and
    ``int(...)`` / ``float(...)`` of a subscript, a method call, a local
    name or a parameter not annotated as a Python number
    (``int(g_off[-1])``, ``int(b.max())``, ``int(lost)``; not
    ``float(softcap)`` of ``softcap: float | None``, nor a read of
    ``.shape`` or of metadata such as ``.numel()``). A wait that must stay
    takes an inline allow whose reason names its ROADMAP item. The check
    reads names only: an implicit ``bool(t)`` (``if t.any():``) and a call
    through an attribute it cannot resolve go unseen, and it stops at the
    dispatch layer (``kernels/ops.py``, ``core/``).
  * ``jit-boundary.silent-catch`` — an ``except Exception``/bare ``except``
    whose ``try`` body touches jit machinery (``.lower()``/``.compile()``,
    a jit-wrapped callable, ``pallas_call``) or reaches a kernel
    (``_build.launch``, ``_build.load``, ``_build.build``, or a function
    that reaches one, by a same-module or imported name) but whose handler
    neither re-raises, constructs a typed taxonomy error, nor records
    telemetry. Around a kernel build or launch the handler must raise or
    hand off to ``runtime/ladder.walk`` (whose rungs keep the plain version
    off the card), and must call no plain version or oracle: a fallback to
    the plain version is a fault there even where a counter records it.
    Around a launch, a handler of ``KernelLaunchError``,
    ``KernelBuildError`` or ``KernelFallbackError`` counts as broad.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.asthelpers import (
    call_name_targets,
    calls_in,
    dotted,
    walk_functions,
)
from repro_torch.analysis.context import ModuleInfo, Project
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

RULE = "jit-boundary"

HOST_SYNC_ATTRS = {"item", "block_until_ready", "tolist"}
HOST_SYNC_CALLS = {"np.asarray", "numpy.asarray", "jax.device_get"}
HOST_SYNC_BUILTINS = {"float"}

# what waits for the device in the port's traced set
TORCH_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
TORCH_SYNC_CALLS = {"np.asarray", "numpy.asarray", "torch.cuda.synchronize"}
TORCH_SYNC_BUILTINS = {"int", "float"}
# what an annotation may name for its parameter to be a Python number
NUMBER_ANNOTATIONS = {"int", "float", "bool", "None", "Optional"}
# methods whose int()/float() reads a tensor's metadata, not its values
METADATA_METHODS = {"numel", "dim", "size", "stride", "data_ptr", "element_size",
                    "storage_offset"}

_TRACE_WRAPPERS = ("jit", "pallas_call")
_TORCH_TRACE_WRAPPERS = {"torch.compile", "torch.cuda.make_graphed_callables"}
_TORCH_GRAPH_CONTEXTS = {"torch.cuda.graph"}

BUILD_MODULE = "kernels/_build.py"  # the launcher
LADDER = ("runtime/ladder.py", "walk")  # the degradation ladder
DISPATCH_MODULE = "kernels/ops.py"  # the dispatch layer (the ladder's)
WRAPPER_PACKAGE = "kernels/"
PLAIN_SUFFIXES = ("_plain", "_ref")  # CPU-only plain versions and oracles
LAUNCHERS = ("launch", "load")  # _build's entries that start a kernel
BUILDERS = ("launch", "load", "build")  # ... and the one that only builds
# what a failed build or launch raises: around a launch, catching one of
# these is as broad as ``except Exception``
KERNEL_FAILURES = frozenset({"KernelLaunchError", "KernelBuildError", "KernelFallbackError"})

FnDef = ast.FunctionDef | ast.AsyncFunctionDef
Key = tuple[str, str]  # (module rel, function name)


def _is_trace_wrapper(name: str) -> bool:
    last = name.rsplit(".", 1)[-1]
    return last in _TRACE_WRAPPERS


def _is_torch_trace_wrapper(name: str) -> bool:
    return name in _TORCH_TRACE_WRAPPERS


def _decorator_traced(fn: FnDef, is_wrapper=_is_trace_wrapper) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if is_wrapper(dotted(target)):
            return True
        # functools.partial(jax.jit, ...) as a decorator factory
        if isinstance(dec, ast.Call):
            for arg in dec.args:
                if is_wrapper(dotted(arg)):
                    return True
    return False


def _module_defs(mod: ModuleInfo) -> dict[str, FnDef]:
    defs: dict[str, FnDef] = {}
    for fn in walk_functions(mod.tree):
        defs.setdefault(fn.name, fn)
    return defs


def _close_same_module(defs: dict[str, FnDef], roots: set[str],
                       skip=lambda name: False) -> dict[str, FnDef]:
    """``roots`` and every same-module function they reach by plain-Name
    call, never entering a function that ``skip`` names."""
    traced = {name for name in roots if not skip(name)}
    frontier = list(traced)
    while frontier:
        fn = defs[frontier.pop()]
        for call in calls_in(fn):
            if isinstance(call.func, ast.Name) and call.func.id in defs:
                callee = call.func.id
                if callee not in traced and not skip(callee):
                    traced.add(callee)
                    frontier.append(callee)
    return {name: defs[name] for name in traced}


def traced_functions(mod: ModuleInfo) -> dict[str, FnDef]:
    """Name → def for every function in ``mod`` that jit/Pallas traces,
    including same-module transitive callees (over-approximate on purpose:
    a helper called from traced code is traced code)."""
    defs = _module_defs(mod)

    roots: set[str] = set()
    for name, fn in defs.items():
        if _decorator_traced(fn):
            roots.add(name)
    # f passed into jax.jit(...) / pallas_call(...) anywhere in the module,
    # including jitted = jax.jit(f) assignments and partial(f, ...) wrapping.
    for call in calls_in(mod.tree):
        if _is_trace_wrapper(dotted(call.func)):
            for target in call_name_targets(call):
                if target in defs:
                    roots.add(target)
    return _close_same_module(defs, roots)


# ----------------------------------------------------------------------
# the port's kernel launches: names resolved across the tree's modules
# ----------------------------------------------------------------------

def is_plain_name(name: str) -> bool:
    """A CPU-only plain version or oracle, left out of the traced set."""
    return name.endswith(PLAIN_SUFFIXES)


class _Index:
    """Every module's functions and what its imported names point at, so a
    call can be resolved to ``(module rel, function name)``."""

    def __init__(self, project: Project):
        self.package = project.root.name
        self.by_rel = {m.rel: m for m in project.modules}
        self.defs = {m.rel: _module_defs(m) for m in project.modules}
        self.top = {m.rel: _top_level_names(m.tree) for m in project.modules}
        self.names: dict[str, dict[str, Key]] = {}
        self.aliases: dict[str, dict[str, str]] = {}
        for m in project.modules:
            self._read_imports(m)

    def module_rel(self, mod: ModuleInfo, module: str | None, level: int) -> str | None:
        """The rel path of a module named in an import in ``mod``, if it is
        one of the tree's."""
        if level:
            parts = mod.rel.split("/")[:-1]
            parts = parts[:len(parts) - (level - 1)] if level > 1 else parts
            parts = parts + (module.split(".") if module else [])
        else:
            head, *parts = (module or "").split(".")
            if head != self.package:
                return None
        for cand in ("/".join([*parts, "__init__"]) + ".py", "/".join(parts) + ".py"):
            if cand in self.by_rel:
                return cand
        return None

    def _read_imports(self, mod: ModuleInfo) -> None:
        names: dict[str, Key] = {}
        aliases: dict[str, str] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    rel = self.module_rel(mod, a.name, 0)
                    if rel is not None:
                        aliases[a.asname or a.name] = rel
            elif isinstance(node, ast.ImportFrom):
                target = self.module_rel(mod, node.module, node.level)
                for a in node.names:
                    local = a.asname or a.name
                    sub = self.module_rel(
                        mod, f"{node.module}.{a.name}" if node.module else a.name,
                        node.level)
                    if target is not None and a.name in self.top[target]:
                        names[local] = (target, a.name)
                    elif sub is not None:
                        aliases[local] = sub
        self.names[mod.rel] = names
        self.aliases[mod.rel] = aliases

    def follow(self, key: Key) -> Key:
        """Through re-exports (``from .x import f`` in a package's
        ``__init__``) to where ``f`` is defined."""
        seen = set()
        while key not in seen:
            seen.add(key)
            rel, name = key
            if name in self.defs.get(rel, {}):
                return key
            nxt = self.names.get(rel, {}).get(name)
            if nxt is None:
                return key
            key = nxt
        return key

    def resolve(self, rel: str, call: ast.Call) -> Key | None:
        """The function a call in module ``rel`` reaches, where a
        same-module or imported name says so."""
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in self.defs[rel]:
                return (rel, func.id)
            key = self.names[rel].get(func.id)
            return self.follow(key) if key is not None else None
        if isinstance(func, ast.Attribute):
            base = dotted(func.value)
            target = self.aliases[rel].get(base)
            if target is None and base:
                target = self.module_rel(self.by_rel[rel], base, 0)
            if target is not None:
                return self.follow((target, func.attr))
        return None

    def is_build_call(self, rel: str, call: ast.Call, entries=LAUNCHERS) -> bool:
        """Does this call reach one of ``_build``'s ``entries``?"""
        key = self.resolve(rel, call)
        if key is not None:
            return key[0] == BUILD_MODULE and key[1] in entries
        name = dotted(call.func)
        return name.startswith("_build.") and name.split(".", 1)[1] in entries


def _top_level_names(tree: ast.Module) -> set[str]:
    """Names a module binds at top level: defs, classes, assignments and
    imports (what ``from module import name`` can pick up)."""
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


def _index(project: Project) -> _Index:
    """One ``_Index`` a project (rules and tests read it more than once)."""
    if "jit_index" not in project._cache:
        project._cache["jit_index"] = _Index(project)
    return project._cache["jit_index"]  # type: ignore[return-value]


def _callees(index: _Index, rel: str, fn: FnDef) -> set[Key]:
    out = set()
    for call in calls_in(fn):
        key = index.resolve(rel, call)
        if key is not None:
            out.add(key)
    return out


def _reaching(index: _Index, candidates: dict[Key, FnDef], entries) -> set[Key]:
    """The candidates that call one of ``_build``'s ``entries``, or call a
    candidate that does, by a same-module or imported name."""
    callees = {key: _callees(index, key[0], fn) for key, fn in candidates.items()}
    found = {key for key, fn in candidates.items()
             if any(index.is_build_call(key[0], c, entries) for c in calls_in(fn))}
    changed = True
    while changed:
        changed = False
        for key in candidates:
            if key not in found and callees[key] & found:
                found.add(key)
                changed = True
    return found


def kernel_wrappers(project: Project) -> set[Key]:
    """``(module rel, name)`` of every kernel wrapper: a function of
    ``kernels/`` (not ``_build.py``, not ``ops.py``, not a plain version)
    that reaches ``_build.launch`` or ``_build.load``."""
    index = _index(project)
    candidates = {
        (rel, name): fn
        for rel, defs in index.defs.items()
        if rel.startswith(WRAPPER_PACKAGE) and rel not in (BUILD_MODULE, DISPATCH_MODULE)
        for name, fn in defs.items() if not is_plain_name(name)}
    return _reaching(index, candidates, LAUNCHERS)


def _torch_roots(mod: ModuleInfo, defs: dict[str, FnDef]) -> set[str]:
    """Functions of ``mod`` that torch compiles or captures into a CUDA
    graph."""
    roots = {name for name, fn in defs.items()
             if _decorator_traced(fn, _is_torch_trace_wrapper)}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and _is_torch_trace_wrapper(dotted(node.func)):
            targets = call_name_targets(node)
            for arg in node.args:
                if isinstance(arg, (ast.Tuple, ast.List)):
                    targets += [e.id for e in arg.elts if isinstance(e, ast.Name)]
            roots.update(t for t in targets if t in defs)
        elif isinstance(node, ast.With) and any(
                isinstance(item.context_expr, ast.Call)
                and dotted(item.context_expr.func) in _TORCH_GRAPH_CONTEXTS
                for item in node.items):
            for stmt in node.body:
                for call in calls_in(stmt):
                    if isinstance(call.func, ast.Name) and call.func.id in defs:
                        roots.add(call.func.id)
    return roots


def torch_traced_functions(project: Project) -> dict[str, dict[str, FnDef]]:
    """Module rel → (name → def) of the port's traced set: the kernel
    wrappers, the functions torch compiles or captures, and the same-module
    helpers they call, without plain versions and oracles."""
    if "torch_traced" in project._cache:
        return project._cache["torch_traced"]  # type: ignore[return-value]
    index = _index(project)
    wrappers = kernel_wrappers(project)
    out: dict[str, dict[str, FnDef]] = {}
    for mod in project.modules:
        defs = index.defs[mod.rel]
        roots = {name for rel, name in wrappers if rel == mod.rel}
        roots |= _torch_roots(mod, defs)
        traced = _close_same_module(defs, roots, skip=is_plain_name)
        if traced:
            out[mod.rel] = traced
    project._cache["torch_traced"] = out
    return out


def launch_reaching_functions(project: Project) -> set[Key]:
    """Every function of the tree that reaches ``_build.launch``,
    ``_build.load`` or ``_build.build``, directly or through functions it
    calls by a same-module or imported name."""
    index = _index(project)
    candidates = {(rel, name): fn for rel, defs in index.defs.items()
                  for name, fn in defs.items()}
    return _reaching(index, candidates, BUILDERS)


# ----------------------------------------------------------------------
# the sub-checks
# ----------------------------------------------------------------------

def _is_number_annotation(ann: ast.expr | None) -> bool:
    """``int``, ``float``, ``bool``, ``float | None``, ``Optional[int]``."""
    if ann is None:
        return False
    names = {n.id for n in ast.walk(ann) if isinstance(n, ast.Name)}
    names |= {"None" for n in ast.walk(ann)
              if isinstance(n, ast.Constant) and n.value is None}
    return names <= NUMBER_ANNOTATIONS and bool(names & {"int", "float", "bool"})


def _value_names(fn: FnDef) -> set[str]:
    """The names in ``fn`` (nested defs included) whose ``int()`` or
    ``float()`` may read a tensor: its locals, and its parameters that are
    not annotated as Python numbers."""
    numbers, names = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            a = node.args
            for x in a.posonlyargs + a.args + a.kwonlyargs:
                (numbers if _is_number_annotation(x.annotation) else names).add(x.arg)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
    return names - numbers


def _reads_values(arg: ast.expr, value_names: set[str]) -> bool:
    """Would ``int(arg)``/``float(arg)`` read a tensor's value (and so wait
    for the device)? A subscript (not of ``.shape``), a method call (not
    of tensor metadata) or a name that may hold a tensor."""
    if isinstance(arg, ast.Subscript):
        return not (isinstance(arg.value, ast.Attribute) and arg.value.attr == "shape")
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute):
        return arg.func.attr not in METADATA_METHODS
    return isinstance(arg, ast.Name) and arg.id in value_names


def _jax_sync(node: ast.Call) -> str | None:
    cname = dotted(node.func)
    last = cname.rsplit(".", 1)[-1]
    if cname in HOST_SYNC_CALLS:
        return cname
    if isinstance(node.func, ast.Attribute) and last in HOST_SYNC_ATTRS:
        return f".{last}()"
    if isinstance(node.func, ast.Name) and last in HOST_SYNC_BUILTINS:
        return f"{last}()"
    return None


def _torch_sync(node: ast.Call, value_names: set[str]) -> str | None:
    cname = dotted(node.func)
    if cname in TORCH_SYNC_CALLS:
        return cname
    if isinstance(node.func, ast.Attribute) and node.func.attr in TORCH_SYNC_ATTRS:
        return f".{node.func.attr}()"
    if isinstance(node.func, ast.Name) and node.func.id in TORCH_SYNC_BUILTINS \
            and len(node.args) == 1 and _reads_values(node.args[0], value_names):
        return f"{node.func.id}()"
    return None


def _direct_jit_touch(node: ast.AST, jit_names: set[str]) -> bool:
    """Does ``node`` itself call into jit machinery?"""
    for call in calls_in(node):
        name = dotted(call.func)
        last = name.rsplit(".", 1)[-1]
        if last in {"lower", "compile"} or _is_trace_wrapper(name):
            return True
        if isinstance(call.func, ast.Name) and call.func.id in jit_names:
            return True
        # jitted-callable dict dispatch: _apply_donated[key](...)
        if isinstance(call.func, ast.Subscript):
            base = dotted(call.func.value)
            if base in jit_names:
                return True
    return False


def _jit_touching_functions(mod: ModuleInfo, jit_names: set[str]) -> set[str]:
    """Functions that touch jit machinery, directly or through same-module
    callees (a try around ``run_cell(...)`` wraps the compile inside it)."""
    defs = {fn.name: fn for fn in walk_functions(mod.tree)}
    touching = {name for name, fn in defs.items()
                if _direct_jit_touch(fn, jit_names)}
    changed = True
    while changed:
        changed = False
        for name, fn in defs.items():
            if name in touching:
                continue
            for call in calls_in(fn):
                if isinstance(call.func, ast.Name) and call.func.id in touching:
                    touching.add(name)
                    changed = True
                    break
    return touching


def _jit_touching(try_body: list[ast.stmt], jit_names: set[str],
                  touching_fns: set[str]) -> bool:
    """Does this try body reach jit machinery (directly or one same-module
    call away)?"""
    for stmt in try_body:
        if _direct_jit_touch(stmt, jit_names):
            return True
        for call in calls_in(stmt):
            if isinstance(call.func, ast.Name) and call.func.id in touching_fns:
                return True
    return False


def _launch_touching(index: _Index, rel: str, try_body: list[ast.stmt],
                     reaching: set[Key]) -> bool:
    """Does this try body reach a kernel build or launch?"""
    for stmt in try_body:
        for call in calls_in(stmt):
            if index.is_build_call(rel, call, BUILDERS):
                return True
            key = index.resolve(rel, call)
            if key is not None and key in reaching:
                return True
    return False


def _handler_is_loud(handler: ast.ExceptHandler, taxonomy: frozenset[str]) -> bool:
    """A handler is acceptable when it re-raises, constructs a typed
    taxonomy error, or records to telemetry (counter augassign,
    ``recorder.note_error``/``record``, ``_count``)."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            last = name.rsplit(".", 1)[-1]
            if last in taxonomy:
                return True
            if last in {"note_error", "record", "_count"}:
                return True
        if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Subscript):
            base = dotted(node.target.value)
            if base.endswith("_COUNTS"):
                return True
    return False


def _launch_handler_is_loud(index: _Index, rel: str,
                            handler: ast.ExceptHandler) -> bool:
    """Around a kernel build or launch, a handler is loud when it raises or
    hands off to ``runtime/ladder.walk``, and calls no plain version or
    oracle: recording a fallback does not make it one the card may take."""
    loud = False
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            loud = True
        elif isinstance(node, ast.Call):
            key = index.resolve(rel, node)
            if is_plain_name(key[1] if key else dotted(node.func)):
                return False
            loud = loud or key == LADDER
    return loud


def _broad(handler: ast.ExceptHandler,
           also: frozenset[str] = frozenset()) -> bool:
    t = handler.type
    if t is None:
        return True
    names = {dotted(t)} if not isinstance(t, ast.Tuple) else {
        dotted(e) for e in t.elts}
    return any(n.rsplit(".", 1)[-1] in {"Exception", "BaseException"} | also
               for n in names)


SYNC_HINT = ("hoist the sync out of the traced body; pass concrete values "
             "in as arguments")
TORCH_SYNC_HINT = ("keep the value on the device or take it from the caller; "
                   "a wait that must stay takes # repro: "
                   "allow[jit-boundary.host-sync] and its ROADMAP item")


def _try_finding(mod: ModuleInfo, node: ast.Try, name: str, jax: bool) -> Finding:
    if jax:
        message = (f"try/except inside jit-traced function '{name}' — the "
                   f"degradation ladder must catch outside jit so a failed "
                   f"trace is never cached")
        hint = ("move the try to the dispatch site (see "
                "kernels/ops.numeric_values) and keep the traced body pure")
    else:
        message = (f"try/except inside '{name}', on the path of a kernel "
                   f"launch — a failed build or launch must reach the "
                   f"dispatch site's ladder as it is")
        hint = ("move the try to the dispatch site (runtime/ladder.walk, "
                "kernels/ops.numeric_values) and keep the launch path pure")
    return Finding(rule=RULE, code=f"{RULE}.try-in-traced", path=mod.rel,
                   line=node.lineno, message=message, hint=hint,
                   snippet=mod.snippet(node.lineno))


@rule(RULE, "failures caught outside jit and kernel launches; no try or "
            "unexplained host wait on a launch's path")
def check(project: Project):
    taxonomy = project.taxonomy_classes()
    index = _index(project)
    torch_traced = torch_traced_functions(project)
    reaching = launch_reaching_functions(project)
    for mod in project.modules:
        traced = traced_functions(mod)
        kernel_path = torch_traced.get(mod.rel, {})

        # names bound to jitted callables in this module (X = jax.jit(f),
        # X = torch.compile(f)); a try around a kernel wrapper is found by
        # _launch_touching
        jit_names: set[str] = set(traced)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if _is_trace_wrapper(dotted(node.value.func)) \
                        or _is_torch_trace_wrapper(dotted(node.value.func)):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            jit_names.add(t.id)

        seen: set[int] = set()  # nodes already reported on a launch's path
        for name in sorted(set(traced) | set(kernel_path),
                           key=lambda n: (traced.get(n) or kernel_path[n]).lineno):
            jax = name in traced
            fn = traced[name] if jax else kernel_path[name]
            value_names = _value_names(fn) if name in kernel_path else set()
            for node in ast.walk(fn):
                if not jax and id(node) in seen:
                    continue  # a nested def, reported with its outer function
                seen.add(id(node))
                if isinstance(node, ast.Try):
                    yield _try_finding(mod, node, name, jax)
                if isinstance(node, ast.Call):
                    hit = _jax_sync(node) if jax else None
                    where, hint = f"jit-traced function '{name}'", SYNC_HINT
                    if hit is None and name in kernel_path:
                        hit = _torch_sync(node, value_names)
                        where = f"'{name}', on the path of a kernel launch"
                        hint = TORCH_SYNC_HINT
                    if hit:
                        yield Finding(
                            rule=RULE, code=f"{RULE}.host-sync",
                            path=mod.rel, line=node.lineno,
                            message=f"host-sync call {hit} inside {where}",
                            hint=hint, snippet=mod.snippet(node.lineno))

        touching_fns = _jit_touching_functions(mod, jit_names)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try):
                continue
            launching = _launch_touching(index, mod.rel, node.body, reaching)
            if not (launching or _jit_touching(node.body, jit_names, touching_fns)):
                continue
            also = KERNEL_FAILURES if launching else frozenset()
            for handler in node.handlers:
                if not _broad(handler, also):
                    continue
                if launching and not _launch_handler_is_loud(index, mod.rel, handler):
                    message = ("broad except around kernel-launching code that "
                               "neither raises nor hands off to the ladder, or "
                               "that falls back to a plain version")
                    hint = ("raise a runtime.validate error, or run the rungs "
                            "through runtime/ladder.walk")
                elif not launching and not _handler_is_loud(handler, taxonomy):
                    message = ("broad except around jit-touching code "
                               "that neither re-raises typed, constructs "
                               "a taxonomy error, nor records telemetry")
                    hint = ("re-raise a runtime.validate error, bump a "
                            "telemetry counter, or annotate with "
                            "# repro: allow[jit-boundary] and a why")
                else:
                    continue
                yield Finding(rule=RULE, code=f"{RULE}.silent-catch",
                              path=mod.rel, line=handler.lineno, message=message,
                              hint=hint, snippet=mod.snippet(handler.lineno))
