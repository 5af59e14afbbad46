"""Structural rules of the PyTorch port.

* paddle_tpu_torch (and chip_smoke.py) import neither jax nor paddle_tpu;
* every CUDA source under ops/kernels/csrc/ has a wrapper module that
  declares its kernels, each with a plain PyTorch version and a launch
  counter;
* every ``torch.autograd.Function`` of a kernel module runs a declared
  backward kernel, which has its own plain version and launch counter;
* nothing is built at import time.
"""
import importlib
import inspect
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.ops.kernels import build, config

ROOT = Path(__file__).resolve().parents[1]
KERNEL_DIR = ROOT / "paddle_tpu_torch" / "ops" / "kernels"


def _all_modules():
    names = ["paddle_tpu_torch"]
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _kernel_modules():
    mods = []
    for info in pkgutil.iter_modules([str(KERNEL_DIR)]):
        mod = importlib.import_module(
            f"paddle_tpu_torch.ops.kernels.{info.name}")
        if hasattr(mod, "KERNELS"):
            mods.append(mod)
    return mods


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['paddle_tpu'] = None\n"
        "import importlib\n"
        f"for name in {_all_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None "
        "and m not in before and (m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'paddle_tpu.'))))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "paddle_tpu_torch").rglob("*.py")))
def test_port_source_names_no_jax_module(path):
    text = (ROOT / path).read_text()
    for bad in ("import jax", "from jax", "import paddle_tpu\n",
                "from paddle_tpu ", "from paddle_tpu.", "import paddle_tpu."):
        assert bad not in text, f"{path} has {bad!r}"


def test_every_cuda_source_has_wrapped_kernels():
    declared = {}
    for mod in _kernel_modules():
        src = inspect.getsource(mod)
        for k in mod.KERNELS:
            assert isinstance(k, config.Kernel)
            assert callable(k.wrapper) and callable(k.plain)
            assert k.plain is not k.wrapper
            # the launch counter sits in the module that launches the kernel
            assert "config.record_call(" in src, mod.__name__
            assert k.replaces.startswith("paddle_tpu/ops/pallas/")
            jax_file = ROOT / k.replaces.split(":")[0]
            assert jax_file.exists(), k.replaces
            declared.setdefault(k.source, []).append(k.name)
    cu = set(build.sources())
    assert cu, "no CUDA sources found"
    assert set(declared) == cu, (declared, cu)
    names = [n for ns in declared.values() for n in ns]
    assert len(names) == len(set(names))


def test_autograd_functions_run_declared_backward_kernels():
    seen = 0
    for mod in _kernel_modules():
        src = inspect.getsource(mod)
        by_wrapper = {k.wrapper.__name__: k for k in mod.KERNELS}
        for obj in vars(mod).values():
            if not (isinstance(obj, type)
                    and issubclass(obj, torch.autograd.Function)
                    and obj.__module__ == mod.__name__):
                continue
            seen += 1
            fwd = inspect.getsource(obj.forward)
            bwd = inspect.getsource(obj.backward)
            calls = lambda text: [k for n, k in by_wrapper.items()
                                  if re.search(rf"\b{n}\(", text)]
            fwd_k, bwd_k = calls(fwd), calls(bwd)
            assert len(fwd_k) == 1 and len(bwd_k) == 1, obj.__name__
            k = bwd_k[0]
            assert k.name != fwd_k[0].name
            assert k.plain.__name__.endswith("_plain"), k.name
            assert inspect.signature(k.plain).parameters.keys() \
                == inspect.signature(k.wrapper).parameters.keys(), k.name
            # the wrapper counts its launches under the kernel's own name
            const = [n for n, v in vars(mod).items() if v == k.name
                     and n.isupper()]
            wrapper = inspect.getsource(k.wrapper)
            assert "config.record_call(" in src
            assert any(c in wrapper for c in const), k.name
    assert seen == 3   # attention, LayerNorm, residual + LayerNorm


def test_cuda_sources_name_the_tpu_kernel_they_replace():
    for mod in _kernel_modules():
        for k in mod.KERNELS:
            text = build.sources()[k.source].read_text()
            fn = k.replaces.split()[-1]
            assert fn in text, (k.source, fn)
            assert "bound" in text.lower()


def test_build_targets_sm90a_into_an_ignored_directory():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    rel = build.BUILD_DIR.relative_to(ROOT)
    ignored = (ROOT / ".gitignore").read_text().split()
    assert f"{rel.parts[0]}/" in ignored


def test_import_builds_nothing():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import paddle_tpu_torch.ops.kernels.build as b\n"
            "import paddle_tpu_torch.ops.kernels.flash_attention_packed\n"
            "import paddle_tpu_torch.ops.kernels.layer_norm\n"
            "import paddle_tpu_torch.optimizer\n"
            "import paddle_tpu_torch.entry\n"
            "import paddle_tpu_torch.text.ernie\n"
            "assert b._libs == {}\n" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_to_run_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
