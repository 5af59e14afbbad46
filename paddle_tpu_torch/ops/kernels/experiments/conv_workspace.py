"""cuDNN's workspace for one fp32 convolution at a large batch, under the
settings that choose its algorithm, each in a fresh process (the plan
cache and the caching allocator's blocks are per process).  It backs
PERF.md's memcheck finding (section 6, PR 23): memcheck prices a program's
live tensors, and the convolution's library workspace is outside them.
Not part of the port: the port imports nothing here.

    python3 paddle_tpu_torch/ops/kernels/experiments/conv_workspace.py

Prints, per variant, the peak bytes allocated during the second call
above its input and output, as one JSON line each.

``install_chunking()`` swaps ``torch.nn.functional.conv2d``, which every
2-D convolution of the port calls, for a variant tried and not kept in the
port: outside autograd, a CUDA convolution whose workspace (read on its
first call from the caching allocator's cumulative count) exceeds its
output runs over ceil(workspace / output) batch chunks written in place
(``aten.cudnn_convolution.out``).  ``phase_experiments.py --phases
conv_paths`` times the port's vision forwards with and without it.
"""
import json
import os
import subprocess
import sys

VARIANTS = ("default", "benchmark", "deterministic", "tf32", "empty_cache",
            "fraction", "chunked_out", "no_v8")


def one(variant, n, c, hw):
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = variant == "tf32"
    torch.backends.cudnn.allow_tf32 = variant == "tf32"
    torch.backends.cudnn.benchmark = variant == "benchmark"
    torch.backends.cudnn.deterministic = variant == "deterministic"
    if variant == "fraction":
        torch.cuda.set_per_process_memory_fraction(0.15)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, c, hw, hw), device="cuda", generator=g)
    w = torch.randn((c, c, 3, 3), device="cuda", generator=g) * 0.05
    b = torch.randn((c,), device="cuda", generator=g)

    def conv():
        if variant != "chunked_out":
            return F.conv2d(x, w, b, 1, 1)
        out = torch.empty((n, c, hw, hw), device="cuda")
        step = max(1, n // 16)
        for i in range(0, n, step):
            torch.ops.aten.cudnn_convolution.out(
                x[i:i + step], w, [1, 1], [1, 1], [1, 1], 1, False, False,
                False, out=out[i:i + step])
        return out.add_(b.view(1, -1, 1, 1))

    if variant == "empty_cache":
        torch.cuda.empty_cache()
    ref = conv()
    del ref
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = conv()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out_bytes = y.numel() * y.element_size()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        conv()
    end.record()
    torch.cuda.synchronize()
    return dict(variant=variant, n=n, c=c, hw=hw,
                workspace_bytes=peak - base - out_bytes,
                out_bytes=out_bytes, ms=start.elapsed_time(end) / 3,
                device=torch.cuda.get_device_name(0))


_LIBRARY_CONV2D = None
_ROWS: dict = {}


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _chunked_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                    groups=1):
    import torch

    stride, dilation = _pair(stride), _pair(dilation)
    cudnn = torch.backends.cudnn
    if not (x.is_cuda and cudnn.enabled and not isinstance(padding, str)
            and x.dim() == 4 and x.shape[0] > 1 and groups == 1
            and dilation == (1, 1) and not cudnn.benchmark
            and not (torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, weight, bias)))):
        return _LIBRARY_CONV2D(x, weight, bias, stride, padding, dilation,
                               groups)
    pad = _pair(padding)
    key = (tuple(x.shape), x.stride(), x.dtype, tuple(weight.shape),
           weight.stride(), bias is not None, stride, pad,
           cudnn.deterministic, cudnn.allow_tf32)
    rows = _ROWS.get(key)
    if not rows:
        stats = torch.cuda.memory_stats
        before = stats()["allocated_bytes.all.allocated"] \
            if rows is None else 0
        out = _LIBRARY_CONV2D(x, weight, bias, stride, pad, dilation, groups)
        if rows is None:
            out_bytes = out.numel() * out.element_size()
            ws = stats()["allocated_bytes.all.allocated"] - before - out_bytes
            _ROWS[key] = -(-x.shape[0] // -(-ws // out_bytes)) \
                if ws > out_bytes else 0
        return out
    n, o = x.shape[0], weight.shape[0]
    oh, ow = ((size + 2 * p - k) // st + 1 for size, k, st, p in
              zip(x.shape[2:], weight.shape[2:], stride, pad))
    nhwc = x.is_contiguous(memory_format=torch.channels_last) \
        and not x.is_contiguous()
    out = torch.empty((n, oh, ow, o) if nhwc else (n, o, oh, ow),
                      dtype=x.dtype, device=x.device)
    view = out.permute(0, 3, 1, 2) if nhwc else out
    for i in range(0, n, rows):
        torch.ops.aten.cudnn_convolution.out(
            x[i:i + rows], weight, list(pad), list(stride), [1, 1], 1,
            False, cudnn.deterministic, cudnn.allow_tf32,
            out=view[i:i + rows])
    if bias is not None:
        view.add_(bias.to(out.dtype).view(1, -1, 1, 1))
    return view


def install_chunking(on=True):
    """Swap the chunking variant in (``on``) or the library's back; returns
    {signature: rows a chunk} of the signatures chunked so far."""
    import torch.nn.functional as tF

    global _LIBRARY_CONV2D
    if _LIBRARY_CONV2D is None:
        _LIBRARY_CONV2D = tF.conv2d
    tF.conv2d = _chunked_conv2d if on else _LIBRARY_CONV2D
    chunked = {k: v for k, v in _ROWS.items() if v}
    _ROWS.clear()
    return chunked


def main():
    if len(sys.argv) > 1:
        variant, n, c, hw = sys.argv[1], *map(int, sys.argv[2:5])
        try:
            print(json.dumps(one(variant, n, c, hw)), flush=True)
        except Exception as e:  # noqa: BLE001 — a variant may not exist
            print(json.dumps(dict(variant=variant, error=repr(e)[:300])),
                  flush=True)
        return 0
    for n, c, hw in ((8192, 128, 16), (8192, 64, 32), (8192, 256, 8)):
        for v in VARIANTS:
            env = dict(os.environ)
            if v == "no_v8":
                env["TORCH_CUDNN_V8_API_DISABLED"] = "1"
            subprocess.run([sys.executable, __file__, v, str(n), str(c),
                            str(hw)], env=env, check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
