"""The port does all the JAX package does: for each module of
``gaussian_splatting_tpu/``, every public top-level function and class has
a counterpart of the same name in the same-named module of
``gaussian_splatting_tpu_torch/`` (``ops/rasterize_pallas.py`` is
``ops/rasterize_cuda.py`` there); ``TrainingConfig`` has the same fields;
and the entry points take the same keyword parameters; every function
the two packages share (top-level, or a method of a same-named class)
gives each parameter it shares the same default. Read with ``ast``, so
nothing is imported. ``ALLOWED_ABSENT`` names each intentional absence and
``ALLOWED_DEFAULTS`` each intentional difference of a default, with its
reason."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "gaussian_splatting_tpu"
PORT_PKG = ROOT / "gaussian_splatting_tpu_torch"
PORT_MODULE = {"ops/rasterize_pallas.py": "ops/rasterize_cuda.py"}

# (JAX module, name) -> why the port has no counterpart.
ALLOWED_ABSENT = {
    ("utils/cache.py", "enable_compile_cache"):
        "XLA's persistent compilation cache; the port compiles its kernels with nvcc into "
        "build/kernels/ and has no JIT compilation to cache",
    ("ops/tiling.py", "padded_capacity_for"):
        "the capacity of the chunk-aligned gradient buffer behind TileBinning.padded_starts, "
        "which no JAX kernel reads any more (the backward appends compactly); the port's "
        "TileBinning has no padded_starts",
    ("utils/profiling.py", "flops_accounting"):
        "TPU v5e pair-op counts over every pair that nothing read; the port's benchmark "
        "counts operations and bytes from the work its inputs need (portbench/work.py)",
}
# (entry point, keyword) -> why the port's entry point does not take it.
ALLOWED_ABSENT_KWARGS = {
    "interpret": "Pallas interpret mode; a port wrapper runs its kernel's plain version "
                 "because its tensors lie on the CPU",
    "direct_dma": "a TPU DMA variant of the queue kernels' window reads; the CUDA kernels "
                  "read global memory directly",
    "_skip_final_sort": "a TPU profiling switch that returns a render-invalid binning",
    "donate": "jax.jit buffer donation; the port's step updates the state in place",
}
# (JAX module, function, parameter) -> why the port's default differs.
ALLOWED_DEFAULTS = {
    ("ops/render.py", "render", "backend"):
        "the JAX package's default is 'ref', its oracle; the port's is 'auto' (the CUDA "
        "kernels), so that a bare render() of CUDA tensors runs the kernels and not an "
        "O(pixels x gaussians) reference; 'ref' stays one keyword away",
}
# The same default written in each framework's terms (JAX -> port).
EQUIVALENT_DEFAULTS = {"jnp.float32": "torch.float32"}
# The Pallas kernel builders (``_make_*``) are private: the port's kernels
# are built from csrc/ by ops/_build.py and bound by their wrappers.

ENTRY_POINTS = [
    ("ops/render.py", "render", None),
    ("ops/render.py", "render_grad_meta", None),
    ("ops/rasterize_pallas.py", "rasterize_tiled", None),
    ("ops/rasterize_pallas.py", "rasterize_grad_meta", None),
    ("ops/tiling.py", "isect_and_sort", None),
    ("training/step.py", "make_train_step", None),
    ("parallel/sharded_step.py", "make_sharded_train_step", None),
    ("ops/facade.py", "__init__", "GaussianRasterizer"),
]


def _tree(path):
    return ast.parse(path.read_text())


def _public_defs(path):
    return {n.name for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def _top_level_names(path):
    """Every name a module binds at top level: definitions, assignments and
    imports (a counterpart may be re-exported)."""
    out = set()
    for n in _tree(path).body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
    return out


def _port_path(rel):
    return PORT_PKG / PORT_MODULE.get(rel, rel)


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    names = _public_defs(JAX_PKG / rel)
    allowed = {n for (m, n) in ALLOWED_ABSENT if m == rel}
    port = _port_path(rel)
    have = _top_level_names(port) if port.exists() else set()
    missing = sorted(names - have - allowed)
    assert not missing, f"{rel}: no counterpart in {port.relative_to(ROOT)} for {missing}"


def test_allow_list_names_only_real_absences():
    """Each allowed absence exists in the JAX package and is absent from the
    port: an entry that the port came to cover goes."""
    for (rel, name), reason in ALLOWED_ABSENT.items():
        assert reason and name in _public_defs(JAX_PKG / rel), (rel, name)
        port = _port_path(rel)
        assert not port.exists() or name not in _top_level_names(port), (rel, name)


def _function(path, name, cls):
    body = _tree(path).body
    if cls is not None:
        body = next(n.body for n in body if isinstance(n, ast.ClassDef) and n.name == cls)
    return next(n for n in body if isinstance(n, ast.FunctionDef) and n.name == name)


def _params(fn):
    return [a.arg for a in fn.args.args + fn.args.kwonlyargs]


@pytest.mark.parametrize("rel,name,cls", ENTRY_POINTS)
def test_entry_points_take_the_same_keywords(rel, name, cls):
    j = _params(_function(JAX_PKG / rel, name, cls))
    t = _params(_function(_port_path(rel), name, cls))
    missing = [p for p in j if p not in t and p not in ALLOWED_ABSENT_KWARGS]
    assert not missing, f"{name}: the port does not take {missing}"
    assert not [p for p in ALLOWED_ABSENT_KWARGS if p in t], name


def test_training_config_has_every_field():
    def fields(path):
        cls = next(n for n in _tree(path).body
                   if isinstance(n, ast.ClassDef) and n.name == "TrainingConfig")
        return [n.target.id for n in cls.body if isinstance(n, ast.AnnAssign)]

    j = fields(JAX_PKG / "training/config.py")
    t = fields(PORT_PKG / "training/config.py")
    assert [f for f in j if f not in t] == []


def _functions(path):
    """Top-level functions and the methods of top-level classes, by
    ``name`` or ``Class.name``."""
    out = {}
    for n in _tree(path).body:
        if isinstance(n, ast.FunctionDef):
            out[n.name] = n
        elif isinstance(n, ast.ClassDef):
            out.update({f"{n.name}.{m.name}": m for m in n.body
                        if isinstance(m, ast.FunctionDef)})
    return out


def _defaults(fn):
    """Parameter -> its default's source text, for the parameters that
    have one."""
    a = fn.args
    pos = a.posonlyargs + a.args
    out = {p.arg: ast.unparse(d) for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults)}
    out.update({p.arg: ast.unparse(d) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                if d is not None})
    return out


def _same_default(j, t):
    try:
        return ast.literal_eval(j) == ast.literal_eval(t)
    except ValueError:
        return EQUIVALENT_DEFAULTS.get(j, j) == t


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_shared_functions_have_the_same_defaults(rel):
    port = _port_path(rel)
    if not port.exists():
        return
    jf, tf = _functions(JAX_PKG / rel), _functions(port)
    differ = []
    for name in sorted(set(jf) & set(tf)):
        jd, td = _defaults(jf[name]), _defaults(tf[name])
        t_params, j_params = _params(tf[name]), _params(jf[name])
        for p in sorted(set(jd) | set(td)):
            if (rel, name, p) in ALLOWED_DEFAULTS or p not in t_params or p not in j_params:
                continue
            if p not in jd or p not in td or not _same_default(jd[p], td[p]):
                differ.append((name, p, jd.get(p), td.get(p)))
    assert not differ, f"{rel}: (function, parameter, JAX default, port default) {differ}"


def test_allowed_defaults_name_only_real_differences():
    """Each allowed difference exists: an entry whose defaults came to agree
    goes."""
    for (rel, name, p), reason in ALLOWED_DEFAULTS.items():
        j = _defaults(_functions(JAX_PKG / rel)[name])[p]
        t = _defaults(_functions(_port_path(rel))[name])[p]
        assert reason and not _same_default(j, t), (rel, name, p)
