"""The tensor op library -- the ``paddle.tensor`` equivalent (counterpart
of paddle_tpu/ops/__init__.py) -- with the attention dispatch and the
hand-written CUDA kernels (``ops.kernels``).

The op library is torch compositions: no Pallas kernel of the JAX package
lies behind its ops (they are jnp / lax there), so none has a kernel here.
The exported set is the JAX package's (``_DEFERRED``, the families a
slice has not ported yet, is empty).  ``ops.crf`` (the linear-chain
CRF) is a module of its own, outside the exported set, as in the JAX
package.
"""
from __future__ import annotations

from .creation import (
    arange,
    assign,
    diag,
    empty,
    empty_like,
    eye,
    full,
    full_like,
    linspace,
    meshgrid,
    ones,
    ones_like,
    to_tensor,
    tril,
    triu,
    zeros,
    zeros_like,
)
from .manipulation import (
    broadcast_to,
    cast,
    chunk,
    concat,
    expand,
    expand_as,
    flatten,
    flip,
    gather,
    gather_nd,
    index_select,
    masked_select,
    put_along_axis,
    repeat_interleave,
    reshape,
    roll,
    scatter,
    scatter_nd_add,
    slice,
    split,
    squeeze,
    stack,
    take_along_axis,
    tile,
    transpose,
    unbind,
    unique,
    unsqueeze,
    unstack,
)
from .math import (
    abs,
    add,
    add_n,
    addmm,
    all,
    allclose,
    amax,
    amin,
    any,
    bmm,
    ceil,
    clip,
    cos,
    cosh,
    cumprod,
    cumsum,
    divide,
    dot,
    einsum,
    erf,
    exp,
    expm1,
    floor,
    floor_divide,
    fmax,
    fmin,
    isfinite,
    isinf,
    isnan,
    kron,
    lerp,
    log,
    log1p,
    log2,
    log10,
    logcumsumexp,
    logit,
    logsumexp,
    matmul,
    max,
    maximum,
    mean,
    min,
    minimum,
    mm,
    mod,
    multiply,
    nanmean,
    nansum,
    outer,
    pow,
    prod,
    reciprocal,
    remainder,
    round,
    rsqrt,
    scale,
    sign,
    sin,
    sinh,
    sqrt,
    square,
    stanh,
    std,
    subtract,
    sum,
    tan,
    tanh,
    trace,
    trunc,
    var,
)
from .logic import (
    bitwise_and,
    bitwise_not,
    bitwise_or,
    bitwise_xor,
    equal,
    equal_all,
    greater_equal,
    greater_than,
    is_empty,
    less_equal,
    less_than,
    logical_and,
    logical_not,
    logical_or,
    logical_xor,
    not_equal,
    where,
)
from .search import (
    argmax,
    argmin,
    argsort,
    index_sample,
    kthvalue,
    masked_fill,
    mode,
    nonzero,
    searchsorted,
    sort,
    topk,
)
from .random import (
    bernoulli,
    multinomial,
    normal,
    rand,
    randint,
    randn,
    randperm,
    standard_normal,
    uniform,
)
from .linalg import (
    cholesky,
    cross,
    det,
    histogram,
    inverse,
    matrix_power,
    norm,
    pinv,
    qr,
    solve,
    svd,
    t,
    triangular_solve,
)
from .attention import flash_attention, scaled_dot_product_attention
from .extra import *  # noqa: F401,F403 -- long-tail tensor ops (extra.__all__)

from .misc import *  # noqa: F401,F403 -- operator-parity tail (misc.__all__)
from .ctc import *  # noqa: F401,F403 -- edit_distance / ctc decode
from .chunking import chunk_eval
from .sequence import (
    segment_max,
    segment_mean,
    segment_min,
    segment_sum,
    sequence_expand,
    sequence_first_step,
    sequence_last_step,
    sequence_mask,
    sequence_pad,
    sequence_pool,
    sequence_reverse,
    sequence_slice,
    sequence_softmax,
    sequence_unpad,
)

from .vision import (
    anchor_generator,
    box_clip,
    box_coder,
    iou_similarity,
    multiclass_nms,
    prior_box,
    roi_align,
    yolo_box,
    yolo_loss,
)

# The JAX package's op families that this port does not export yet, by
# module, and each module's name: none.
_DEFERRED = {}
_DEFERRED_NAMES = frozenset(
    [n for names in _DEFERRED.values() for n in names] + list(_DEFERRED))

# ``kernels`` (imported by ``attention``) is the port's own subpackage, not
# an op; ``chunking`` holds ``chunk_eval`` under another name than the JAX
# package's ``chunk`` submodule, so that ``chunk`` stays manipulation's op
# (in the JAX package the submodule shadows it)
__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("kernels", "chunking")]
