"""The port does all the JAX package does: for each module of
``gaussian_splatting_tpu/``, every public top-level function and class has
a counterpart of the same name in the same-named module of
``gaussian_splatting_tpu_torch/`` (``ops/rasterize_pallas.py`` is
``ops/rasterize_cuda.py`` there); ``TrainingConfig`` has the same fields;
and the entry points take the same keyword parameters. Read with ``ast``,
so nothing is imported. ``ALLOWED_ABSENT`` names each intentional absence
with its reason."""

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
