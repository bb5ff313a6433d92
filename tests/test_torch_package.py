"""The port's package surface: it imports no jax, ships its CUDA sources,
and carries the flagship config unchanged."""

import subprocess
import sys
import tomllib
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Every module of `ccdm_tpu_torch` imports with jax, flax and the JAX
    package made unimportable."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "ccdm_tpu_torch").rglob("*.py"))
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'ccdm_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"import importlib\nfor m in {modules!r}:\n    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 18
    assert {"ccdm_tpu_torch.models.dino", "ccdm_tpu_torch.eval.cityscapes_eval",
            "ccdm_tpu_torch.config"} <= set(modules)


def test_flagship_params_match_graft_entry():
    from __graft_entry__ import FLAGSHIP_PARAMS as jax_side
    from ccdm_tpu_torch import FLAGSHIP_PARAMS

    assert FLAGSHIP_PARAMS == jax_side


def test_packaging_names_the_port():
    with open(REPO / "pyproject.toml", "rb") as f:
        cfg = tomllib.load(f)
    assert "ccdm_tpu_torch*" in cfg["tool"]["setuptools"]["packages"]["find"]["include"]
    globs = cfg["tool"]["setuptools"]["package-data"]["ccdm_tpu_torch"]
    assert "csrc/*.cu" in globs and "csrc/*.cuh" in globs
    assert any(m.startswith("gpu:") for m in cfg["tool"]["pytest"]["ini_options"]["markers"])
    assert {p.name for p in (REPO / "ccdm_tpu_torch/csrc").glob("*.cu")} >= {
        "group_norm.cu", "flash_attention.cu"}


def test_kernel_library_rebuilds_when_a_source_is_newer(tmp_path, monkeypatch):
    import os

    from ccdm_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// kernel\n")
    (src / "k.cuh").write_text("// header\n")
    lib = tmp_path / "libccdm_kernels.so"
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "LIB_PATH", lib)
    assert _build._stale()  # never built
    lib.write_bytes(b"")
    os.utime(src / "k.cu", (1_000, 1_000))
    os.utime(src / "k.cuh", (1_000, 1_000))
    os.utime(lib, (2_000, 2_000))
    assert not _build._stale()
    os.utime(src / "k.cuh", (3_000, 3_000))  # a header edit counts too
    assert _build._stale()
