"""Structural rules of the PyTorch port.

* paddle_tpu_torch (and chip_smoke.py) import neither jax nor paddle_tpu;
* every CUDA source under ops/kernels/csrc/ has a wrapper module that
  declares its kernels, each with a plain PyTorch version and a launch
  counter;
* every ``torch.autograd.Function`` of a kernel module runs a declared
  backward kernel, which has its own plain version and launch counter,
  unless the module names the JAX VJP it repeats in torch
  (``PLAIN_BACKWARD``) and that VJP reaches no Pallas kernel;
* nothing is built at import time: no CUDA kernel, and not the native
  host runtime (``core.native``), which ``io`` and ``hapi`` reach;
* in ``parallel/`` and ``distributed/`` no ``try`` around a collective
  has an ``except`` that would let the collective fail quietly.
"""
import ast
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


def test_import_scan_covers_every_package_of_the_port():
    names = _all_modules()
    for pkg in ("amp", "autograd", "core", "dygraph", "io", "nn",
                "ops.kernels", "optimizer", "serving", "slim", "static",
                "text", "utils", "vision", "vision.models", "hapi",
                "metric", "parallel", "distributed"):
        assert f"paddle_tpu_torch.{pkg}" in names, pkg
    for mod in ("serving.paged", "serving.slo", "serving.continuous",
                "utils.monitor", "core.errors", "ops.kernels.paged_attention",
                "ops.kernels.flash_attention", "ops.kernels.conv_fused",
                "ops.kernels.pooling", "nn.initializer",
                "nn.functional.conv", "nn.functional.pooling",
                "static.framework", "static.registry", "static.layers",
                "static.nets", "static.ops", "static.ops_fused",
                "static.passes", "static.executor", "static.ops_tail",
                "static.ops_tail2", "static.ops_tail3", "static.ops_tail4",
                "static.ops_tail5", "static.ops_tail6", "static.ops_tail7",
                "static.analysis", "static.memcheck", "static.shardcheck",
                "static.op_coverage",
                "ops.kernels.bn_act_train", "ops.kernels.int8", "slim.quant",
                "slim.quant_static", "optimizer.lr", "optimizer.grad_clip",
                "nn.layer.conv", "nn.layer.loss", "nn.layer.base",
                "nn.layer.activation", "core.tape", "ops.creation",
                "ops.manipulation", "ops.math", "ops.logic", "ops.search",
                "ops.random", "ops.linalg", "ops.extra", "ops.cases",
                "core.lod", "ops.sequence", "ops.crf", "ops.chunking",
                "ops.ctc", "ops.misc", "nn.functional.rnn", "nn.layer.rnn",
                "nn.layer.norm", "nn.layer.pooling", "nn.layer.extras",
                "nn.decode", "optimizer.extras", "ops.vision", "io.dataset",
                "vision.datasets", "vision.transforms",
                "vision.models.resnet", "vision.models.yolov3",
                "core.native", "io.sampler", "io.dataloader", "io.prefetch",
                "io.multislot", "metric.metrics", "text.datasets",
                "hapi.model", "hapi.callbacks", "utils.profiler",
                "utils.trace", "utils.checkpoint", "distributed.env",
                "distributed.launch", "parallel.mesh", "parallel.collective",
                "parallel.compress", "parallel.data_parallel",
                "parallel.metrics", "parallel.fleet", "parallel.sharding",
                "parallel.pipeline", "parallel.ring_attention",
                "nn.layer.moe", "text.pretrainer"):
        assert f"paddle_tpu_torch.{mod}" in names, mod


def test_paged_attention_kernel_is_declared():
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    (k,) = pa.KERNELS
    assert k.source == "paged_attention" and k.source in build.sources()
    assert k.replaces == ("paddle_tpu/ops/pallas/paged_attention.py:116 "
                          "paged_attention_kernel")
    assert k.plain is pa.paged_attention_plain
    assert inspect.signature(k.plain).parameters.keys() \
        == inspect.signature(k.wrapper).parameters.keys()
    assert "config.record_call(KERNEL)" in inspect.getsource(k.wrapper)


@pytest.mark.parametrize("module,kernels,replaces", [
    ("conv_fused", ("conv2d_bn_act",),
     "paddle_tpu/ops/pallas/conv_fused.py:152 conv2d_bn_act"),
    ("pooling", ("max_pool2d", "avg_pool2d"),
     "paddle_tpu/ops/pallas/pooling.py:91 _pool2d_nhwc"),
])
def test_vision_kernels_are_declared(module, kernels, replaces):
    mod = importlib.import_module(f"paddle_tpu_torch.ops.kernels.{module}")
    assert tuple(k.name for k in mod.KERNELS) == kernels
    for k in mod.KERNELS:
        assert k.source == mod.SOURCE and k.source in build.sources()
        assert k.replaces == replaces
        assert k.plain.__name__.endswith("_plain")
        assert inspect.signature(k.plain).parameters.keys() \
            == inspect.signature(k.wrapper).parameters.keys()
        src = inspect.getsource(k.wrapper)
        assert "config.record_call(" in src and "try:" not in src
    # neither TPU function has a VJP: no autograd Function here
    assert not any(isinstance(o, type)
                   and issubclass(o, torch.autograd.Function)
                   for o in vars(mod).values())


@pytest.mark.parametrize("module,kernels,replaces", [
    ("bn_act_train", ("bn_batch_stats", "bn_scale_act"),
     ("paddle_tpu/ops/pallas/conv_fused.py:234 _batch_stats",
      "paddle_tpu/ops/pallas/conv_fused.py:251 scale_act")),
    ("int8", ("int8_matmul_dequant", "int8_conv2d_dequant"),
     ("paddle_tpu/ops/pallas/int8.py:92 int8_matmul_dequant",
      "paddle_tpu/ops/pallas/int8.py:166 int8_conv2d_dequant")),
])
def test_training_and_int8_kernels_are_declared(module, kernels, replaces):
    mod = importlib.import_module(f"paddle_tpu_torch.ops.kernels.{module}")
    assert tuple(k.name for k in mod.KERNELS) == kernels
    assert tuple(k.replaces for k in mod.KERNELS) == replaces
    for k in mod.KERNELS:
        assert k.source in build.sources()
        text = build.sources()[k.source].read_text()
        assert k.replaces.split()[-1] in text
        assert k.replaces.split()[0].split(":")[0].split("/")[-1] in text
        assert k.plain.__name__.endswith("_plain")
        assert inspect.signature(k.plain).parameters.keys() \
            == inspect.signature(k.wrapper).parameters.keys()
        src = inspect.getsource(k.wrapper)
        assert "config.record_call(" in src and "try:" not in src
        # each TPU line named is the function's own def
        path, line = k.replaces.split()[0].split(":")
        jax_line = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert jax_line.startswith(f"def {k.replaces.split()[-1]}(")


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


def _calls(node):
    """Dotted names of the calls under ``node`` ("dist.all_reduce")."""
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f, parts = sub.func, []
            while isinstance(f, ast.Attribute):
                parts.append(f.attr)
                f = f.value
            if isinstance(f, ast.Name):
                parts.append(f.id)
            out.append(".".join(reversed(parts)))
    return out


COLLECTIVE_CALL = re.compile(
    r"(^|\.)(all_reduce|all_gather\w*|all_to_all\w*|reduce_scatter\w*|"
    r"broadcast|reduce|scatter|barrier|send|recv|isend|irecv|"
    r"batch_isend_irecv|ppermute|optimized_all_reduce|"
    r"all_reduce_compressed|bucketed_all_reduce|sync_gradients|"
    r"init_process_group|new_group|new_subgroups_by_enumeration|"
    r"init_device_mesh|_exchange|_gather_tiled|_sum_into|_flat_sum_|"
    r"_gather_stack|_all_to_all_tiled)$")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for sub in ("parallel", "distributed")
    for p in (ROOT / "paddle_tpu_torch" / sub).rglob("*.py")))
def test_no_try_lets_a_collective_fail_quietly(path):
    """In the port's parallel/ and distributed/ packages no ``try`` around a
    collective (or a process-group set-up) has an ``except``: a collective
    that fails raises, it does not go on without its result."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and node.handlers:
            called = [c for stmt in node.body for c in _calls(stmt)
                      if COLLECTIVE_CALL.search(c)]
            assert not called, (path, node.lineno, called)


def test_every_cuda_source_has_wrapped_kernels():
    declared = {}
    for mod in _kernel_modules():
        src = inspect.getsource(mod)
        # the launch counter sits in the module that launches the kernel
        if "build.load(" in src:
            assert "config.record_call(" in src, mod.__name__
        for k in mod.KERNELS:
            assert isinstance(k, config.Kernel)
            assert callable(k.wrapper) and callable(k.plain)
            assert k.plain is not k.wrapper
            # ... under the kernel's own name, which the wrapper names
            const = [n for n, v in vars(mod).items() if v == k.name
                     and n.isupper()]
            assert any(c in inspect.getsource(k.wrapper) for c in const), \
                k.name
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
    seen = plain_seen = 0
    for mod in _kernel_modules():
        src = inspect.getsource(mod)
        by_wrapper = {k.wrapper.__name__: k for k in mod.KERNELS}
        for obj in vars(mod).values():
            if not (isinstance(obj, type)
                    and issubclass(obj, torch.autograd.Function)
                    and obj.__module__ == mod.__name__):
                continue
            fwd = inspect.getsource(obj.forward)
            bwd = inspect.getsource(obj.backward)
            calls = lambda text: [k for n, k in by_wrapper.items()
                                  if re.search(rf"\b{n}\(", text)]
            fwd_k, bwd_k = calls(fwd), calls(bwd)
            plain_vjp = getattr(mod, "PLAIN_BACKWARD", None)
            if plain_vjp is not None:
                # the JAX VJP is plain jnp math: a torch backward, no kernel
                path, rest = plain_vjp.split(":")
                line, name = rest.split()
                lines = (ROOT / path).read_text().splitlines()
                assert lines[int(line) - 1].startswith(f"def {name}(")
                body = []
                for text in lines[int(line):]:
                    if text and not text[0].isspace():
                        break
                    body.append(text)
                assert "pallas_call" not in "\n".join(body)
                assert fwd_k and not bwd_k, obj.__name__
                plain_seen += 1
                continue
            seen += 1
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
    # attention (both layouts), LayerNorm, residual + LN; train-mode BN
    assert seen == 3 and plain_seen == 1


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
            "import paddle_tpu_torch.ops.kernels.flash_attention\n"
            "import paddle_tpu_torch.ops.kernels.flash_attention_packed\n"
            "import paddle_tpu_torch.ops.kernels.layer_norm\n"
            "import paddle_tpu_torch.ops.kernels.paged_attention\n"
            "import paddle_tpu_torch.ops.kernels.conv_fused\n"
            "import paddle_tpu_torch.ops.kernels.pooling\n"
            "import paddle_tpu_torch.ops.kernels.bn_act_train\n"
            "import paddle_tpu_torch.ops.kernels.int8\n"
            "import paddle_tpu_torch.slim\n"
            "import paddle_tpu_torch.static\n"
            "import paddle_tpu_torch.serving\n"
            "import paddle_tpu_torch.optimizer\n"
            "import paddle_tpu_torch.entry\n"
            "import paddle_tpu_torch.text.ernie\n"
            "import paddle_tpu_torch.core.native as native\n"
            "import paddle_tpu_torch.io\n"
            "import paddle_tpu_torch.hapi\n"
            "import paddle_tpu_torch.metric\n"
            "import paddle_tpu_torch.utils.trace\n"
            "import paddle_tpu_torch.utils.checkpoint\n"
            "import paddle_tpu_torch.parallel\n"
            "import paddle_tpu_torch.distributed.launch\n"
            "assert b._libs == {}\n"
            "assert not native._build_attempted and native._lib is None\n"
            % str(ROOT))
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
