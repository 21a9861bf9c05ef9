"""The port stands alone: no JAX, nothing of ``repro``, and it runs.

- every ``repro_torch`` module imports in a fresh interpreter in which
  ``jax`` and ``repro`` cannot be imported;
- no source of the port (nor ``chip_smoke.py``) imports them;
- the build finds all six kernel sources, and each wrapper's ctypes
  signature matches its C entry point;
- the launcher serves the qwen2-7b smoke config on the CPU;
- ``chip_smoke.py`` refuses to run without a card.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b|import repro\.|"
                       r"import repro\b(?!_)|from repro\.|from repro import)",
                       re.M)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.serving.engine" in mods and len(mods) > 30
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {str(f.relative_to(ROOT)): FORBIDDEN.findall(f.read_text())
           for f in files}
    assert {f: m for f, m in bad.items() if m} == {}
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.serving import x")
    assert FORBIDDEN.search("from repro import obs")
    assert not FORBIDDEN.search("from repro_torch.serving import x")


def test_kernel_sources_are_found_by_the_build():
    from repro_torch.kernels import _build
    assert set(_build.sources()) == {"paged_attention", "flash_attention",
                                     "fused_update", "lowering_conv",
                                     "wgrad", "dgrad", "ssm_decode"}
    for name, src in _build.sources().items():
        text = src.read_text()
        assert 'extern "C" int' in text and "cudaGetLastError" in text
        if name == "ssm_decode":                 # the card's own kernel
            assert "Replaces no TPU kernel" in text
        else:
            assert "src/repro/kernels/" in text  # names the TPU kernel
        lib = _build.target(src)
        assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    assert _build.BUILD_DIR == ROOT / "build" / "repro_torch"


_WRAPPERS = {   # kernel -> (module of its wrapper, name of its ARGTYPES)
    "paged_attention": ("paged_attention.ops", "ARGTYPES"),
    "flash_attention": ("flash_attention.ops", "ARGTYPES"),
    "fused_update": ("fused_update.ops", "ARGTYPES"),
    "lowering_conv": ("lowering_conv.lowering_conv", "ARGTYPES"),
    "wgrad": ("lowering_conv.bwd", "WGRAD_ARGTYPES"),
    "dgrad": ("lowering_conv.bwd", "DGRAD_ARGTYPES"),
}


@pytest.mark.parametrize("name", list(_WRAPPERS))
def test_ctypes_signature_matches_the_c_entry_point(name):
    """ctypes passes each argument as its declared type: one mismatch
    cuts a pointer or shifts every later argument."""
    import ctypes
    import importlib
    from repro_torch.kernels import _build
    module, attr = _WRAPPERS[name]
    ops = importlib.import_module(f"repro_torch.kernels.{module}")
    text = _build.sources()[name].read_text()
    sig = re.search(rf'extern "C" int {name}_launch\((.*?)\)', text, re.S)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float, "long long": ctypes.c_longlong}
    params = [" ".join(p.split()[:-1]).replace("const ", "")
              for p in sig.group(1).split(",")]
    assert [kinds[p] for p in params] == getattr(ops, attr)


def test_launcher_serves_smoke_config_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-7b", "--smoke", "--mode", "continuous", "--device", "cpu",
         "--attn-impl", "torch", "--requests", "4"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "continuous: 4 reqs" in out.stdout


def test_chip_smoke_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
