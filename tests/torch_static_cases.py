"""One-op static programs for the port's op table: each case builds the
same single-op program in both packages from the same numpy inputs (made
from a seed), runs it through both Executors on the CPU and compares the
fetches.  fp32 outputs agree within 1e-5 of the largest magnitude, integer
and bool outputs exactly (the dtype's kind must match: int32 and int64 are
both integers), and random ops are compared by shape, moments and seed
repeatability; what a random op computes from its draw (a gather at the
drawn indices, the noise's scale, the dropout mask's values) is checked
by the case's ``verify``.

Cases come from two places: the declared inputs, attrs and output slots of
the JAX package's ``OpTest`` classes (tests/test_op_harness.py,
tests/test_ops_tail*.py), and the hand-written table below for every other
op type the port registers.  ``cases()`` lists them all; ``run`` builds and
runs one case in one package.
"""
from __future__ import annotations

import contextlib
import importlib
import inspect
from typing import Dict, List

import numpy as np

# The op types of the JAX package's registry that the port leaves for a
# later slice: none.
LATER = frozenset()

# The 130 op types of ops_tail2-7.py (collectives, RNN monoliths, fusion
# ops, LoD arrays, PS data-plane ops, the contrib / detection tails) the
# static graph's op tail brought in; chip_smoke.py runs their cases on the
# card against the CPU.
TAIL_9C = frozenset("""
c_allreduce_sum c_allreduce_max c_allreduce_min c_allreduce_prod c_allgather
c_reducescatter c_broadcast c_comm_init c_comm_init_all c_gen_nccl_id
c_sync_calc_stream c_sync_comm_stream gen_nccl_id sync_batch_norm lstm lstmp
cudnn_lstm gru fusion_lstm fusion_gru fused_embedding_fc_lstm
fusion_repeated_fc_relu fusion_squared_mat_sub fusion_seqpool_concat
fusion_seqconv_eltadd_relu max_pool3d_with_index unpool write_to_array
read_from_array array_to_lod_tensor lod_tensor_to_array shrink_rnn_memory
merge_lod_tensor split_lod_tensor distributed_lookup_table pull_sparse
pull_sparse_v2 push_sparse push_sparse_v2 c_embedding merge_ids split_ids
split_selected_rows split_byref lookup_sparse_table_merge print quantize
dequantize requantize merge_lod_tensor_infer
attention_lstm tree_conv pyramid_hash var_conv_2d bilateral_slice
sequence_reshape sequence_scatter select_input select_output
fusion_seqexpand_concat_fc
unique unique_with_counts where_index hash sequence_enumerate sequence_erase
proximal_adagrad proximal_gd positive_negative_pair dgc dgc_momentum
dgc_clip_by_norm c_reduce_sum c_reduce_max c_reduce_min c_reduce_prod
c_scatter barrier
allreduce broadcast allclose bernoulli eye fill fill_zeros_like2 diag_v2
diag_embed histogram randint randperm sampling_id seed modified_huber_loss
add_position_encoding amp_check_finite_and_scale fake_init
bilinear_tensor_product gaussian_random_batch_size_like
uniform_random_batch_size_like sequence_expand_as fake_dequantize_max_abs
dequantize_abs_max fake_channel_wise_dequantize_max_abs dequantize_log
fake_quantize_moving_average_abs_max average_accumulates precision_recall
spp polygon_box_transform random_crop hierarchical_sigmoid bipartite_match
target_assign mine_hard_examples assert
generate_proposals rpn_target_assign matrix_nms box_decoder_and_assign
distribute_fpn_proposals collect_fpn_proposals
tdm_child tdm_sampler match_matrix_tensor sequence_topk_avg_pooling
retinanet_target_assign deformable_psroi_pooling generate_proposal_labels
retinanet_detection_output roi_perspective_transform
""".split())

# Op types the sub-block lowerings, the backward region and the fused
# passes own: held against the JAX Executor by their own tests
# (tests/test_torch_static_control_flow.py, test_torch_static*.py).
STRUCTURAL = frozenset({"conditional_block", "while", "static_rnn",
                        "backward_region"})


class Case:
    def __init__(self, op_type, inputs, attrs=None, outs=("Out",), name="",
                 random=False, tol=1e-5, expect=None, prep=None,
                 verify=None, pre=(), post=(), bind=None, feeds=None):
        self.op_type = op_type
        self.inputs = {k: (list(v) if isinstance(v, (list, tuple)) else [v])
                       for k, v in inputs.items()}
        self.attrs = dict(attrs or {})
        self.outs = ({k: 1 for k in outs} if isinstance(outs, (list, tuple))
                     else dict(outs))
        self.id = op_type + (f"-{name}" if name else "")
        self.random = random
        self.tol = tol
        # expected fetches where the JAX Executor cannot run the op (a
        # bound its trace needs as a constant): compared like JAX's
        self.expect = expect
        # prep(tmpdir) writes the files a load op reads
        self.prep = prep
        # verify(case, got, want) holds a random op's fetches to what they
        # must be given its own draw: the deterministic slots against the
        # JAX package's, the rest against numpy on the drawn values
        self.verify = verify
        # ops around the case's op, each (type, {slot: [names]},
        # {slot: [names]}, attrs): ``pre`` build what it reads (an input
        # given as a str names such a variable instead of a feed), and
        # the last of ``post`` gives the fetches (a tensor array, say,
        # stacked back into a tensor)
        self.pre = tuple(pre)
        self.post = tuple(post)
        # feeds the ``pre`` ops read, {name: array}
        self.feeds = dict(feeds or {})
        # bind(static) sets up package state the op reads (a PS table)
        self.bind = bind


_R = np.random.default_rng(20261018)


def f(*shape, lo=None, hi=None):
    if lo is None:
        return _R.normal(0, 1, shape).astype(np.float32)
    return _R.uniform(lo, hi, shape).astype(np.float32)


def i(*shape, lo=0, hi=5):
    return _R.integers(lo, hi, shape).astype(np.int32)


def b(*shape):
    return _R.random(shape) < 0.5


def _a(*vals, dtype=np.float32):
    return np.asarray(vals, dtype)


_X = f(2, 3, 4)
_P = f(3, 4, lo=0.1, hi=2.0)        # positive
_U = f(3, 4, lo=-0.9, hi=0.9)       # inside (-1, 1)
_IMG = f(1, 2, 6, 6)

HAND: List[Case] = []


def C(*a, **k):
    HAND.append(Case(*a, **k))


def _close(case, g, w, where):
    """``g`` within the case's tolerance of the largest ``|w|``."""
    g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
    assert g.shape == w.shape, (where, g.shape, w.shape)
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= case.tol * max(float(np.abs(w).max()), 1e-6), (where, err)


def _v_shuffle_batch(case, got, want):
    """Out is X at ShuffleIdx, and ShuffleIdx a permutation, in both."""
    x = case.inputs["X"][0]
    for who, res in (("port", got), ("jax", want)):
        idx = np.asarray(res["ShuffleIdx"][0])
        np.testing.assert_array_equal(np.sort(idx), np.arange(len(x)),
                                      err_msg=who)
        np.testing.assert_array_equal(res["Out"][0], x[idx], err_msg=who)


def _v_sample_logits(case, got, want):
    """The label column and SampledLabels equal JAX's; every sampled
    column is Logits at the port's own Samples less log(n / C)."""
    logits = case.inputs["Logits"][0]
    labels = case.inputs["Labels"][0].reshape(-1)
    n, C = case.attrs["num_samples"], logits.shape[1]
    np.testing.assert_array_equal(got["SampledLabels"][0],
                                  want["SampledLabels"][0])
    np.testing.assert_array_equal(got["SampledLabels"][0], 0)
    s = np.asarray(got["Samples"][0])
    np.testing.assert_array_equal(s[:, 0], np.asarray(want["Samples"][0])[:, 0])
    np.testing.assert_array_equal(s[:, 0], labels)
    assert ((s >= 0) & (s < C)).all(), s
    out = np.asarray(got["SampledLogits"][0])
    _close(case, out[:, 0], np.asarray(want["SampledLogits"][0])[:, 0],
           "SampledLogits[:, 0] vs JAX")
    expect = np.take_along_axis(logits, s, 1)
    expect[:, 1:] -= np.log(np.float32(n / C))
    _close(case, out, expect, "SampledLogits vs Logits at Samples")


def _v_dpsgd(case, got, want):
    """The noise the port added, (Param - lr * clipped Grad - ParamOut) /
    (lr * sigma * clip), is N(0, 1) by its moments."""
    p, g = case.inputs["Param"][0], case.inputs["Grad"][0]
    lr = case.inputs["LearningRate"][0].item()
    clip, sigma = case.attrs["clip"], case.attrs["sigma"]
    g = g.astype(np.float64)
    g_clip = g / max(1.0, np.linalg.norm(g) / clip)
    z = (p - lr * g_clip - np.asarray(got["ParamOut"][0], np.float64)) \
        / (lr * sigma * clip)
    assert abs(z.mean()) <= 0.15 and abs(z.std() - 1.0) <= 0.15, \
        (z.mean(), z.std())


def _v_dropout(case, got, want):
    """upscale_in_train: each Out is 0 or X / (1 - p), about p of them 0."""
    x, p = case.inputs["X"][0], case.attrs["dropout_prob"]
    out = np.asarray(got["Out"][0])
    dropped = out == 0
    _close(case, out[~dropped], x[~dropped] / (1 - p), "kept Out vs X/(1-p)")
    assert abs(dropped.mean() - p) <= 0.05, dropped.mean()


def _v_range(lo, hi):
    def verify(case, got, want):
        """Every draw inside [lo, hi]."""
        out = np.asarray(got["Out"][0])
        assert out.min() >= lo and out.max() <= hi, (out.min(), out.max())
    return verify


# -- ops.py ------------------------------------------------------------------
C("cast", {"X": f(2, 3) * 3}, {"out_dtype": "int32"})
C("cast", {"X": i(2, 3)}, {"out_dtype": "float32"}, name="int")
C("scale", {"X": _X}, {"scale": 2.0, "bias": 1.0, "bias_after_scale": False})
for _t in ("exp", "abs", "floor", "ceil", "softsign", "sin", "cos", "tan",
           "atan", "sinh", "cosh", "round", "sign", "expm1", "erf", "selu",
           "logsigmoid"):
    C(_t, {"X": f(3, 4) * 2})
for _t in ("log", "sqrt", "rsqrt", "reciprocal", "log2", "log10", "log1p"):
    C(_t, {"X": _P})
for _t in ("asin", "acos"):
    C(_t, {"X": _U})
C("reduce_max", {"X": _X}, {"dim": [1], "keep_dim": False})
C("reduce_min", {"X": _X}, {"dim": [0, 2], "keep_dim": True})
C("reduce_prod", {"X": _X * 0.5 + 1}, {"dim": [1, 2], "keep_dim": False})
C("sum", {"X": [f(2, 3), f(2, 3), f(2, 3)]})
C("clip", {"X": _X}, {"min": -0.5, "max": 0.5})
C("split", {"X": f(4, 6)}, {"axis": 1, "num": 3}, outs={"Out": 3})
C("split", {"X": f(4, 6)}, {"axis": 1, "sections": [1, 2, 3]},
  outs={"Out": 3}, name="sections")
C("stack", {"X": [f(2, 3), f(2, 3)]}, {"axis": 1}, outs=("Y",))
C("squeeze2", {"X": f(2, 1, 3, 1)}, {"axes": [1]}, outs=("Out", "XShape"))
C("unsqueeze2", {"X": f(2, 3)}, {"axes": [0, 2]}, outs=("Out", "XShape"))
C("reshape", {"X": _X}, {"shape": [0, -1]}, outs=("Out",))
C("transpose", {"X": _X}, {"axis": [2, 0, 1]}, outs=("Out",))
C("lookup_table_v2", {"W": f(10, 4), "Ids": i(2, 3, hi=10)},
  {"padding_idx": 2})
C("top_k", {"X": f(3, 6)}, {"k": 2}, outs=("Out", "Indices"))
C("arg_max", {"X": f(3, 5)}, {"axis": 1})
C("arg_min", {"X": f(3, 5)}, {"axis": 0})
_CA, _CB = i(3, 4).astype(np.float32), i(3, 4).astype(np.float32)
for _t in ("less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal"):
    C(_t, {"X": _CA, "Y": _CB})
_BA, _BB = b(3, 4), b(3, 4)
for _t in ("logical_and", "logical_or", "logical_xor"):
    C(_t, {"X": _BA, "Y": _BB})
C("logical_not", {"X": _BA})
C("increment", {"X": _a(3.0)}, {"step": 2.0})
C("increment", {"X": np.asarray([3], np.int32)}, {"step": 1.0}, name="int")
C("hard_sigmoid", {"X": f(3, 4) * 4}, {"slope": 0.2, "offset": 0.5})
C("pow", {"X": _P}, {"factor": 3.0})
C("log_softmax", {"X": f(3, 5)}, {"axis": 1})
C("cumsum", {"X": f(3, 4)}, {"axis": 1, "exclusive": True, "reverse": True},
  name="exclusive-reverse")
C("cumsum", {"X": f(3, 4)}, {"flatten": True, "exclusive": True},
  name="flatten")
C("gather", {"X": f(5, 3), "Index": _a(4, 0, 2, dtype=np.int32)},
  {"axis": 0})
C("gather_nd", {"X": f(3, 4, 2), "Index": _a([0, 1], [2, 3],
                                              dtype=np.int32)})
C("scatter", {"X": f(5, 3), "Ids": _a(3, 1, dtype=np.int32),
              "Updates": f(2, 3)}, {"overwrite": True})
C("scatter", {"X": f(5, 3), "Ids": _a(3, 1, dtype=np.int32),
              "Updates": f(2, 3)}, {"overwrite": False}, name="add")
C("slice", {"Input": f(4, 5)}, {"axes": [0, 1], "starts": [1, -3],
                                 "ends": [3, 100]})
C("expand_v2", {"X": f(1, 3)}, {"shape": [4, -1]})
C("tile", {"X": f(2, 3)}, {"repeat_times": [2, 1, 2]})
C("where", {"Condition": b(3, 4), "X": f(3, 4), "Y": f(3, 4)})
C("one_hot_v2", {"X": _a(0, 3, 4, 1, dtype=np.int32)}, {"depth": 5})
C("range", {"Start": _a(1.0), "End": _a(7.0), "Step": _a(1.5)},
  expect={"Out": [np.arange(1.0, 7.0, 1.5, dtype=np.float32)]})
C("shape", {"Input": _X})
C("fill_constant_batch_size_like", {"Input": f(3, 2)},
  {"shape": [-1, 4], "value": 1.5, "dtype": "float32",
   "input_dim_idx": 0, "output_dim_idx": 0})
C("fill_zeros_like", {"X": _X})
C("pad2d", {"X": _IMG}, {"paddings": [1, 0, 2, 1], "mode": "constant",
                         "pad_value": 0.5})
C("pad2d", {"X": _IMG}, {"paddings": [1, 2, 2, 1], "mode": "reflect"},
  name="reflect")
C("pad", {"X": f(2, 3)}, {"paddings": [1, 0, 0, 2], "pad_value": 1.0})
C("maximum", {"X": f(3, 4), "Y": f(3, 4)})
C("minimum", {"X": f(3, 4), "Y": f(3, 4)})
C("squared_l2_norm", {"X": _X})
C("huber_loss", {"X": f(4, 1), "Y": f(4, 1)}, {"delta": 0.5},
  outs=("Out", "Residual"))
C("smooth_l1_loss", {"X": f(4, 3), "Y": f(4, 3)}, {"sigma": 2.0},
  outs=("Out", "Diff"))
C("relu_grad_passthrough", {"X": _X})
_SL = (_R.random((3, 4)) < 0.5).astype(np.float32)
_SL[0, 0] = -100
C("sigmoid_cross_entropy_with_logits", {"X": f(3, 4), "Label": _SL},
  {"normalize": True}, name="normalize")
C("log_loss", {"Predicted": f(4, 1, lo=0.05, hi=0.95),
               "Labels": (_R.random((4, 1)) < 0.5).astype(np.float32)},
  {"epsilon": 1e-4}, outs=("Loss",))
C("label_smooth", {"X": np.eye(4, dtype=np.float32)[[0, 2, 1]]},
  {"epsilon": 0.1})
C("norm", {"X": f(3, 4)}, {"axis": 1, "epsilon": 1e-10},
  outs=("Out", "Norm"))
_LP = np.log(np.full((3, 4), 0.25, np.float32))
C("kldiv_loss", {"X": _LP, "Target": f(3, 4, lo=0.05, hi=0.5)},
  {"reduction": "batchmean"}, outs=("Loss",))
_LEN = _a(5, 2, 3, dtype=np.int32)
C("sequence_mask", {"X": _LEN}, {"maxlen": 6, "out_dtype": "float32"},
  outs=("Y",))
_SEQ = f(3, 5, 2)
for _t in ("sequence_last_step_padded", "sequence_first_step_padded"):
    C(_t, {"X": _SEQ, "Lengths": _LEN})
for _t in ("sequence_pool_padded", "sequence_pool"):
    C(_t, {"X": _SEQ, "Lengths": _LEN}, {"pooltype": "AVERAGE"})
C("sequence_pool_padded", {"X": _SEQ, "Lengths": _LEN}, {"pooltype": "max"},
  name="max")
for _t in ("sequence_softmax_padded", "sequence_softmax"):
    C(_t, {"X": f(3, 5), "Lengths": _LEN})
for _t in ("sequence_reverse_padded", "sequence_reverse"):
    C(_t, {"X": _SEQ, "Lengths": _LEN}, outs=("Y",))
for _t in ("sequence_conv_padded", "sequence_conv"):
    C(_t, {"X": _SEQ, "Filter": f(6, 4), "Lengths": _LEN},
      {"contextLength": 3, "contextStart": -1})
C("conv2d_transpose", {"Input": f(1, 2, 4, 4), "Filter": f(2, 3, 3, 3)},
  {"strides": 2, "paddings": 1}, outs=("Output",))
C("group_norm", {"X": f(2, 4, 3, 3), "Scale": f(4), "Bias": f(4)},
  {"groups": 2, "epsilon": 1e-5}, outs=("Y",))
C("instance_norm", {"X": f(2, 3, 4, 4), "Scale": f(3), "Bias": f(3)},
  {"epsilon": 1e-5}, outs=("Y",))
C("prelu", {"X": f(2, 3, 4), "Alpha": _a(0.25)})
C("resize_interp", {"X": f(1, 2, 4, 4)},
  {"out_shape": [6, 7], "interp_method": "bilinear",
   "align_corners": False})
C("prior_box", {"Input": f(1, 2, 4, 4), "Image": f(1, 3, 16, 16)},
  {"min_sizes": [4.0], "max_sizes": [8.0], "aspect_ratios": [2.0],
   "flip": True, "clip": True}, outs=("Boxes", "Variances"))
_PB = np.sort(f(3, 4, lo=0.0, hi=1.0).reshape(3, 2, 2), axis=1).reshape(3, 4)
C("box_coder", {"PriorBox": _PB, "PriorBoxVar": np.full((3, 4), 0.1,
                                                         np.float32),
                "TargetBox": np.sort(f(2, 4, lo=0, hi=1).reshape(2, 2, 2),
                                     axis=1).reshape(2, 4)},
  {"code_type": "encode_center_size"}, outs=("OutputBox",))
_ROIS = _a([0.5, 0.5, 4.0, 3.5], [1.0, 2.0, 5.0, 5.5])
C("roi_align", {"X": _IMG, "ROIs": _ROIS},
  {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0,
   "sampling_ratio": 2})
_EM, _TR = f(2, 4, 3), f(5, 3)
C("linear_chain_crf", {"Emission": _EM, "Label": i(2, 4, hi=3),
                       "Transition": _TR, "Length": _a(4, 3,
                                                       dtype=np.int32)},
  outs=("LogLikelihood",))
C("crf_decoding", {"Emission": _EM, "Transition": _TR,
                   "Length": _a(4, 3, dtype=np.int32)},
  outs=("ViterbiPath",))
C("pixel_shuffle", {"X": f(1, 4, 2, 2)}, {"upscale_factor": 2})
C("space_to_depth", {"X": f(1, 1, 4, 4)}, {"blocksize": 2})
C("shuffle_channel", {"X": f(1, 4, 2, 2)}, {"group": 2})
C("temporal_shift", {"X": f(4, 4, 2, 2)}, {"seg_num": 2,
                                           "shift_ratio": 0.25})
C("cos_sim", {"X": f(3, 4), "Y": f(3, 4)})
C("lrn", {"X": f(1, 4, 3, 3)}, {"n": 3, "k": 1.0, "alpha": 1e-2,
                                "beta": 0.75})
C("multiplex", {"X": [f(3, 4), f(3, 4)], "Ids": _a([1], [0], [1],
                                                   dtype=np.int32)})
C("rank_loss", {"Label": (_R.random((3, 1)) < 0.5).astype(np.float32),
                "Left": f(3, 1), "Right": f(3, 1)})
C("sigmoid_focal_loss", {"X": f(3, 4), "Label": i(3, 1, hi=5),
                         "FgNum": _a(2, dtype=np.int32)},
  {"gamma": 2.0, "alpha": 0.25})
C("grid_sampler", {"X": f(1, 2, 4, 4), "Grid": f(1, 3, 3, 2, lo=-1, hi=1)},
  outs=("Output",))
C("affine_grid", {"Theta": f(1, 2, 3)}, {"output_shape": [1, 2, 4, 4]},
  outs=("Output",))
C("roi_pool", {"X": _IMG, "ROIs": _a([0, 0, 3, 3], [1, 2, 5, 5])},
  {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0})
C("row_conv", {"X": _SEQ, "Filter": f(2, 2), "Lengths": _LEN})
C("nce", {"Input": f(3, 4), "Label": i(3, 1, hi=10), "Weight": f(10, 4),
          "Bias": f(10), "SampleIds": i(3, 2, hi=10)},
  {"num_total_classes": 10}, outs=("Cost",))

# -- ops_tail.py ---------------------------------------------------------------
C("depthwise_conv2d_transpose", {"Input": f(1, 2, 3, 3),
                                 "Filter": f(2, 1, 3, 3)},
  {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
   "output_padding": [0, 0]},
  outs=("Output",))
C("max_pool2d_with_index", {"X": f(1, 2, 4, 4)},
  {"ksize": [2, 2], "strides": [2, 2]}, outs=("Out", "Mask"))
C("im2sequence", {"X": f(1, 2, 4, 4)}, {"kernels": [2, 2],
                                        "strides": [2, 2],
                                        "paddings": [0, 0, 1, 1]})
C("spectral_norm", {"Weight": f(4, 6), "U": f(4)}, {"power_iters": 2})
C("affine_channel", {"X": f(2, 3, 2, 2), "Scale": f(3), "Bias": f(3)})
C("conv_shift", {"X": f(2, 5), "Y": f(2, 3)})
for _t in ("bilinear_interp", "nearest_interp", "bicubic_interp"):
    C(_t, {"X": f(1, 2, 4, 4)}, {"out_h": 6, "out_w": 5,
                                 "align_corners": True})
C("nearest_interp_v2", {"X": f(1, 2, 4, 4)}, {"out_h": 8, "out_w": 8,
                                               "align_corners": False})
C("trilinear_interp", {"X": f(1, 1, 3, 3, 3)},
  {"out_d": 4, "out_h": 4, "out_w": 4, "align_corners": True})
for _t in ("linear_interp", "linear_interp_v2"):
    C(_t, {"X": f(1, 2, 5)}, {"out_w": 8, "align_corners": True})
C("yolov3_loss", {"X": f(1, 2 * 7, 4, 4), "GTBox": f(1, 2, 4, lo=0.2,
                                                      hi=0.6),
                  "GTLabel": i(1, 2, hi=2)},
  {"anchors": [10, 13, 16, 30, 33, 23], "anchor_mask": [0, 1],
   "class_num": 2, "ignore_thresh": 0.7, "downsample_ratio": 8},
  outs=("Loss",), tol=1e-4)
C("multiclass_nms2", {"BBoxes": np.sort(f(1, 5, 4, lo=0, hi=1).reshape(
    1, 5, 2, 2), axis=2).reshape(1, 5, 4), "Scores": f(1, 2, 5, lo=0, hi=1)},
  {"score_threshold": 0.1, "nms_threshold": 0.5, "keep_top_k": 4,
   "background_label": -1}, outs=("Out", "NmsRoisNum"))
C("deformable_conv_v1", {"Input": f(1, 2, 5, 5),
                         "Offset": f(1, 18, 3, 3) * 0.5,
                         "Filter": f(3, 2, 3, 3)},
  {"strides": [1, 1], "paddings": [0, 0]}, outs=("Output",), tol=1e-4)
_BX = np.sort(f(3, 4, lo=0, hi=1).reshape(3, 2, 2), axis=1).reshape(3, 4)
C("iou_similarity", {"X": _BX, "Y": _BX[:2]})
C("box_clip", {"Input": f(1, 3, 4, lo=-5, hi=40),
               "ImInfo": np.asarray([20.0, 30.0, 1.0], np.float32)}, outs=("Output",))
C("anchor_generator", {"Input": f(1, 2, 3, 3)},
  {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0],
   "stride": [16.0, 16.0]}, outs=("Anchors", "Variances"))
C("beam_search_decode", {"Ids": i(3, 2, 2, hi=9),
                         "ParentIdx": i(3, 2, 2, hi=2),
                         "Scores": f(3, 2, 2)},
  outs=("SentenceIds", "SentenceScores"))
C("fake_quantize_abs_max", {"X": _X}, {"bit_length": 8},
  outs=("Out", "OutScale"))
C("moving_average_abs_max_scale", {"X": _X, "InScale": _a(0.8)},
  {"moving_rate": 0.9}, outs=("Out", "OutScale"))
C("fake_quantize_range_abs_max", {"X": _X, "InScale": _a(0.5)},
  {"bit_length": 8}, outs=("Out", "OutScale"))
C("fake_channel_wise_quantize_abs_max", {"X": f(3, 2, 2)},
  {"quant_axis": 0}, outs=("Out", "OutScale"))
C("dist", {"X": f(3, 4), "Y": f(3, 4)}, {"p": 3.0})
C("l1_norm", {"X": _X})
C("reverse", {"X": _X}, {"axis": [0, 2]})
_MS = (f(3, 4), b(3, 4))
# data-dependent output shape: the JAX Executor's trace cannot run it
C("masked_select", {"X": _MS[0], "Mask": _MS[1]}, outs=("Y",),
  expect={"Y": [_MS[0][_MS[1]]]})
C("crop", {"X": f(4, 5)}, {"shape": [2, 3], "offsets": [1, 1]})
C("crop_tensor", {"X": f(4, 5)}, {"shape": [3, 2], "offsets": [0, 2]})
C("expand_as", {"X": f(1, 3), "target_tensor": f(4, 3)})
C("pad_constant_like", {"X": f(4, 5), "Y": f(2, 3)}, {"pad_value": 0.5})
C("scatter_nd_add", {"X": f(4, 3), "Index": _a([1], [3], [1],
                                               dtype=np.int32),
                     "Updates": f(3, 3)})
C("cvm", {"X": f(3, 5, lo=0.5, hi=3)}, {"use_cvm": True}, outs=("Y",))
C("data_norm", {"X": f(3, 4), "BatchSize": np.full(4, 10.0, np.float32),
                "BatchSum": f(4), "BatchSquareSum": f(4, lo=5, hi=10)},
  outs=("Y", "BatchSizeOut", "BatchSumOut", "BatchSquareSumOut"))
C("cos_sim_v2", {"X": f(3, 4), "Y": f(3, 4)})
C("squared_l2_distance", {"X": f(3, 4), "Y": f(3, 4)},
  outs=("Out", "sub_result"))
C("clip_by_norm", {"X": f(3, 4)}, {"max_norm": 1.0})
C("size", {"Input": _X})
_NF = f(3, 4)
_NF[0, 1], _NF[1, 2], _NF[2, 0] = np.inf, np.nan, -np.inf
for _t in ("isfinite_v2", "isinf_v2", "isnan_v2", "isfinite"):
    C(_t, {"X": _NF})
C("batch_fc", {"Input": f(2, 3, 4), "W": f(2, 4, 5), "Bias": f(2, 1, 5)})
C("shuffle_batch", {"X": f(6, 3)}, outs=("Out", "ShuffleIdx"), random=True,
  verify=_v_shuffle_batch)
for _t in ("lod_reset", "get_tensor_from_selected_rows",
           "merge_selected_rows"):
    C(_t, {"X": f(3, 4)})
C("coalesce_tensor", {"Input": [f(2, 3), f(4)]},
  outs={"Output": 2, "FusedOutput": 1})
C("nll_loss", {"X": np.log(f(4, 3, lo=0.1, hi=1)), "Label": i(4, hi=3)},
  {"reduction": "mean"}, outs=("Out", "Total_weight"))
C("hinge_loss", {"Logits": f(4, 1),
                 "Labels": (_R.random((4, 1)) < 0.5).astype(np.float32)},
  outs=("Loss",))
C("margin_rank_loss", {"X1": f(4, 1), "X2": f(4, 1),
                       "Label": np.sign(f(4, 1))}, {"margin": 0.1})
C("center_loss", {"X": f(4, 3), "Label": i(4, 1, hi=5), "Centers": f(5, 3),
                  "CenterUpdateRate": _a(0.5)}, {"need_update": True},
  outs=("Loss", "SampleCenterDiff", "CentersOut"))
for _t, _at in [("soft_relu", {"threshold": 2.0}),
                ("brelu", {"t_min": -0.5, "t_max": 0.5}),
                ("stanh", {"scale_a": 0.5, "scale_b": 1.5}),
                ("thresholded_relu", {"threshold": 0.3}),
                ("hard_shrink", {"threshold": 0.5}),
                ("softshrink", {"lambda": 0.4}), ("tanh_shrink", {}),
                ("hard_tanh", {"t_min": -0.3, "t_max": 0.6})]:
    C(_t, {"X": f(3, 4)}, _at)
_AP = f(20, 1, lo=0, hi=1)
C("auc", {"Predict": np.concatenate([1 - _AP, _AP], 1),
          "Label": (_R.random((20, 1)) < 0.5).astype(np.int32)},
  {"num_thresholds": 63}, outs=("AUC", "StatPosOut", "StatNegOut"))
C("sequence_pad", {"X": f(6, 2), "SegmentIds": _a(0, 0, 0, 1, 2, 2,
                                                  dtype=np.int32)},
  {"batch": 3, "maxlen": 4, "pad_value": -1.0}, outs=("Out", "Length"))
C("sequence_unpad", {"X": _SEQ, "Length": _LEN},
  outs=("Out", "SegmentIds", "Mask"))
_SE = (f(3, 2, 2), _a(2, 1, 2, dtype=np.int32), _a(2, 3, 1, dtype=np.int32))


def _sequence_expand_eager():
    # the JAX lowering binds Out to the (out, lengths) pair its eager op
    # returns (ROADMAP Queue 3), and its trace cannot take the lengths as
    # traced values: the expectation is the JAX eager op's first result
    from paddle_tpu.ops import sequence as S

    return {"Out": [np.asarray(S.sequence_expand(*_SE, 4)[0])]}


for _t in ("sequence_expand_padded", "sequence_expand"):
    C(_t, {"X": _SE[0], "Length": _SE[1], "RefLength": _SE[2]},
      {"maxlen": 4}, expect=_sequence_expand_eager)
for _t in ("sequence_slice_padded", "sequence_slice"):
    C(_t, {"X": _SEQ, "Length": _LEN, "Offset": _a(1, 0, 1, dtype=np.int32),
           "SliceLength": _a(2, 2, 1, dtype=np.int32)},
      outs=("Out", "OutLength"))
for _t in ("sequence_concat_padded", "sequence_concat"):
    C(_t, {"X": [f(1, 4, 2), f(1, 3, 2)],
           "Length": [_a(3, dtype=np.int32), _a(2, dtype=np.int32)]},
      outs=("Out", "OutLength"))
# the JAX lowering reshapes a (1, T) index to (B, T, ...) and so runs only
# at batch 1 (ROADMAP Queue 3): batch 3 against numpy
_SC = (f(3, 4, 2), f(3, 3, 2), _a(4, 2, 1, dtype=np.int32),
       _a(1, 3, 2, dtype=np.int32))
_SC_OUT = np.zeros((3, 7, 2), np.float32)
for _r in range(3):
    _rows = np.concatenate([_SC[0][_r, :_SC[2][_r]], _SC[1][_r, :_SC[3][_r]]])
    _SC_OUT[_r, :len(_rows)] = _rows
C("sequence_concat_padded", {"X": [_SC[0], _SC[1]],
                             "Length": [_SC[2], _SC[3]]},
  outs=("Out", "OutLength"), name="batch3",
  expect={"Out": [_SC_OUT], "OutLength": [_SC[2] + _SC[3]]})
C("is_empty", {"X": f(0, 3)})
C("teacher_student_sigmoid_loss", {"X": f(5, 1),
                                   "Label": _a([0.0], [1.0], [0.3], [0.7],
                                               [0.0])}, outs=("Y",))
C("reduce_all", {"X": b(3, 4)}, {"dim": [1], "keep_dim": False})
C("reduce_any", {"X": b(3, 4)}, {"reduce_all": True})
C("diag", {"Diagonal": f(4)})

# -- the op types of ops_tail2 / ops_tail3 / ops_tail5 the DSL emits ---------
C("fsp", {"X": f(2, 3, 4, 4), "Y": f(2, 5, 4, 4)})
C("inplace_abn", {"X": f(4, 3, 2, 2), "Scale": f(3), "Bias": f(3),
                  "Mean": np.zeros(3, np.float32),
                  "Variance": np.ones(3, np.float32)},
  {"is_test": False, "activation": "leaky_relu", "alpha": 0.1},
  outs=("Y", "MeanOut", "VarianceOut"))
C("cross_entropy2", {"X": f(4, 5, lo=0.05, hi=1), "Label": i(4, 1, hi=5)},
  {"ignore_index": 3}, outs=("Y", "MatchX", "XShape"))
C("sample_logits", {"Logits": f(4, 10), "Labels": i(4, 1, hi=10)},
  {"num_samples": 3}, outs=("SampledLogits", "Samples", "SampledLabels"),
  random=True, verify=_v_sample_logits)
C("prroi_pool", {"X": f(2, 2, 6, 6), "ROIs": _a([0.5, 0.5, 4.0, 3.5],
                                                 [1.0, 2.0, 5.0, 5.5],
                                                 [0.0, 0.0, 5.0, 5.0]),
                 "BatchRoINums": _a(2, 1, dtype=np.int32)},
  {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 1.0}, tol=1e-4)
C("filter_by_instag", {"Ins": f(4, 3), "Ins_tag": _a([1, -1], [2, 3],
                                                      [4, -1], [3, 1],
                                                      dtype=np.int32),
                       "Filter_tag": _a(3, 4, dtype=np.int32)},
  outs=("Out", "LossWeight", "IndexMap"))
C("chunk_eval", {"Inference": _a([0, 1, 2, 0, 1, 4], [2, 1, 4, 0, 1, 2],
                                 dtype=np.int32),
                 "Label": _a([0, 1, 2, 0, 3, 4], [2, 1, 4, 0, 1, 2],
                             dtype=np.int32),
                 "SeqLength": _a(6, 5, dtype=np.int32)},
  {"chunk_scheme": "IOB", "num_chunk_types": 2},
  outs=("Precision", "Recall", "F1-Score", "NumInferChunks",
        "NumLabelChunks", "NumCorrectChunks"))
C("fc", {"Input": f(2, 3, 4), "W": f(12, 5), "Bias": f(5)},
  {"in_num_col_dims": 1, "activation_type": "relu"})
C("save", {"X": f(2, 3)}, {"file_path": "{tmp}/x.npy"}, outs=())
C("save_combine", {"X": [f(2, 3), f(4)]}, {"file_path": "{tmp}/xy.npz"},
  outs=())
C("py_func", {"X": [f(2, 3)]}, {"forward_callable_id": "{py_func}",
                                "out_shapes": [[2, 3]],
                                "out_dtypes": ["float32"]})



def _write_npy(tmp):
    np.save(f"{tmp}/in.npy", _LOADED[0])


def _write_npz(tmp):
    np.savez(f"{tmp}/in.npz", out_out_0=_LOADED[0], out_out_1=_LOADED[1])


_LOADED = (f(2, 3), i(4))
C("load", {}, {"file_path": "{tmp}/in.npy"}, prep=_write_npy)
C("load_combine", {}, {"file_path": "{tmp}/in.npz"}, outs={"Out": 2},
  prep=_write_npz)

# -- the op types earlier slices ported ----------------------------------------
for _t in ("fill_constant",):
    C(_t, {}, {"shape": [2, 3], "dtype": "float32", "value": 1.5})
for _t, _at, _v in [
        ("uniform_random", {"min": -2.0, "max": 3.0}, _v_range(-2.0, 3.0)),
        ("gaussian_random", {"mean": 1.0, "std": 2.0}, None),
        ("truncated_gaussian_random", {"mean": 0.5, "std": 1.0},
         _v_range(-1.5, 2.5))]:
    C(_t, {}, {"shape": [64, 32], "dtype": "float32", "seed": 0, **_at},
      random=True, verify=_v)
C("assign", {"X": _X})
C("assign_value", {}, {"shape": [2, 2], "dtype": "float32",
                       "fp32_values": [1.0, 2.0, 3.0, 4.0]})
for _t in ("elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_min", "elementwise_pow",
           "elementwise_mod", "elementwise_floordiv"):
    C(_t, {"X": f(2, 3, 4, lo=0.5, hi=3), "Y": f(3, lo=0.5, hi=3)},
      {"axis": 1})
C("matmul", {"X": f(2, 3, 4), "Y": f(2, 5, 4)},
  {"transpose_Y": True, "alpha": 0.5})
for _t in ("relu", "sigmoid", "gelu", "softplus", "silu", "swish", "mish",
           "relu6", "hard_swish", "square"):
    C(_t, {"X": f(3, 4) * 3})
C("leaky_relu", {"X": f(3, 4)}, {"alpha": 0.1})
C("elu", {"X": f(3, 4)}, {"alpha": 0.5})
C("mean", {"X": _X})
for _t in ("reduce_sum", "reduce_mean"):
    C(_t, {"X": _X}, {"dim": [1], "keep_dim": True})
C("reshape2", {"X": _X}, {"shape": [0, -1]}, outs=("Out", "XShape"))
C("transpose2", {"X": _X}, {"axis": [1, 0, 2]}, outs=("Out", "XShape"))
C("flatten2", {"X": _X}, {"axis": 2}, outs=("Out", "XShape"))
C("flatten_contiguous_range", {"X": f(2, 3, 4, 2)},
  {"start_axis": 1, "stop_axis": 2}, outs=("Out", "XShape"))
C("conv2d", {"Input": _IMG, "Filter": f(3, 2, 3, 3), "Bias": f(3)},
  {"strides": [1, 1], "paddings": [1, 1]}, outs=("Output",))
C("pool2d", {"X": _IMG}, {"pooling_type": "avg", "ksize": [2, 2],
                          "strides": [2, 2], "paddings": [0, 0]})
C("batch_norm", {"X": f(4, 3, 2, 2), "Scale": f(3), "Bias": f(3),
                 "Mean": np.zeros(3, np.float32),
                 "Variance": np.ones(3, np.float32)},
  {"is_test": False, "momentum": 0.9}, outs=("Y", "MeanOut", "VarianceOut"))
C("dropout", {"X": _X}, {"dropout_prob": 0.3, "is_test": True})
C("dropout", {"X": f(64, 64)}, {"dropout_prob": 0.3, "is_test": False},
  name="train", random=True, verify=_v_dropout)
C("softmax_with_cross_entropy", {"Logits": f(4, 5), "Label": i(4, 1, hi=5)},
  outs=("Loss", "Softmax"))
C("cross_entropy", {"X": f(4, 5, lo=0.05, hi=1), "Label": i(4, 1, hi=5)},
  outs=("Y",))
C("square_error_cost", {"X": f(4, 1), "Label": f(4, 1)})
C("accuracy", {"Out": f(6, 4), "Label": i(6, 1, hi=4)},
  outs=("Accuracy", "Correct", "Total"))
_OPT = {"Param": f(3, 4), "Grad": f(3, 4), "LearningRate": _a(0.1)}
C("sgd", _OPT, outs=("ParamOut",))
C("momentum", {**_OPT, "Velocity": f(3, 4)}, {"mu": 0.9,
                                              "use_nesterov": True},
  outs=("ParamOut", "VelocityOut"))
_ADAM = {**_OPT, "Moment1": f(3, 4), "Moment2": f(3, 4, lo=0.1, hi=1),
         "Beta1Pow": _a(0.9), "Beta2Pow": _a(0.999)}
_ADAM_OUTS = ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut")
C("adam", _ADAM, outs=_ADAM_OUTS)
C("adamw", _ADAM, {"coeff": 0.01}, outs=_ADAM_OUTS)
C("lamb", _ADAM, {"weight_decay": 0.01}, outs=_ADAM_OUTS)
C("decayed_adagrad", {**_OPT, "Moment": f(3, 4, lo=0.1, hi=1)},
  outs=("ParamOut", "MomentOut"))
C("adadelta", {**_OPT, "AvgSquaredGrad": f(3, 4, lo=0.1, hi=1),
               "AvgSquaredUpdate": f(3, 4, lo=0.1, hi=1)},
  outs=("ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"))
C("lars_momentum", {**_OPT, "Velocity": f(3, 4)},
  outs=("ParamOut", "VelocityOut"))
C("dpsgd", {"Param": f(64, 32), "Grad": f(64, 32), "LearningRate": _a(0.1)},
  {"clip": 1.0, "sigma": 0.5}, outs=("ParamOut",), random=True,
  verify=_v_dpsgd)
C("dpsgd", _OPT, {"clip": 1.0, "sigma": 0.0}, outs=("ParamOut",),
  name="sigma0")
C("fake_quantize_dequantize_moving_average_abs_max",
  {"X": _X, "InScale": _a(0.8)}, {"moving_rate": 0.9},
  outs=("Out", "OutScale"))
C("fake_quantize_dequantize_fixed_scale", {"X": _X}, {"scale": 1.5})

# -- the pass pipeline's fused ops (their CUDA kernels run on the card; on
#    the CPU each wrapper runs its plain version) ------------------------------
_BN = {"Scale": f(3, lo=0.5, hi=1.5), "BnBias": f(3),
       "Mean": f(3) * 0.1, "Variance": f(3, lo=0.5, hi=1.5)}
C("fused_conv2d_bn_act", {"Input": _IMG, "Filter": f(3, 2, 3, 3), **_BN},
  {"act": "relu", "strides": 1, "paddings": 1, "is_test": True},
  outs=("Output",), tol=1e-4)
C("fused_conv2d_bn_act", {"Input": _IMG, "Filter": f(3, 2, 3, 3), **_BN},
  {"act": "relu", "strides": 1, "paddings": 1, "is_test": False},
  outs=("Output", "MeanOut", "VarianceOut"), name="train", tol=1e-4)
C("fused_matmul_bias_act", {"X": f(4, 6), "Y": f(6, 5), "Bias": f(5)},
  {"act": "relu"})
_QW = np.round(f(3, 2, 3, 3) * 40).astype(np.float32)
C("quant_conv2d", {"Input": _IMG, "Filter": _QW, "Bias": f(3)},
  {"act": "relu", "strides": 1, "paddings": 1, "in_scale": 2.5,
   "weight_scale": [40.0, 40.0, 40.0]}, outs=("Output",), tol=1e-4)
C("quant_mul", {"X": f(4, 6), "Y": np.round(f(6, 5) * 40).astype(
    np.float32)}, {"act": "", "in_scale": 2.5,
                   "weight_scale": [40.0] * 5}, tol=1e-4)

# -- ops_tail2-7.py: the static graph's op tail -------------------------------
# (collectives run with no group bound: the identities of one device; the
# 2-rank reductions are held in tests/test_torch_static_tail.py)


def _ps_table(static):
    """A fresh seeded SparseTable named "emb" in ``static``'s package."""
    pkg = static.__name__.rsplit(".", 1)[0]
    table = importlib.import_module(pkg + ".distributed.ps").SparseTable(
        dim=4, num_shards=2, optimizer="sgd", seed=9)
    importlib.import_module(static.__name__ + ".ops_tail2") \
        .register_ps_table("emb", table)


def _v_bernoulli(case, got, want):
    """Out is 0 or 1, at about X's mean rate."""
    x, out = case.inputs["X"][0], np.asarray(got["Out"][0])
    assert set(np.unique(out)) <= {0.0, 1.0}
    assert abs(out.mean() - x.mean()) <= 0.03, (out.mean(), x.mean())


def _v_int_range(lo, hi, slot="Out"):
    def verify(case, got, want):
        """Every draw an integer in [lo, hi], every value drawn."""
        out = np.asarray(got[slot][0])
        assert out.dtype.kind in "iu" and out.min() >= lo \
            and out.max() <= hi, (out.min(), out.max())
        assert len(np.unique(out)) == hi - lo + 1
    return verify


def _v_randperm(case, got, want):
    """A permutation of range(n)."""
    out = np.sort(np.asarray(got["Out"][0]))
    np.testing.assert_array_equal(out, np.arange(case.attrs["n"]))


def _v_sampling_id(case, got, want):
    """Each class drawn at about its mean probability over the rows."""
    x, out = case.inputs["X"][0], np.asarray(got["Out"][0]).reshape(-1)
    freq = np.bincount(out, minlength=x.shape[1]) / len(out)
    np.testing.assert_allclose(freq, x.mean(0), atol=0.04)


def _v_seed(case, got, want):
    out = np.asarray(got["Out"][0])
    assert out.shape == (1,) and 1 <= int(out[0]) < 2 ** 31 - 1


def _v_normal_like(case, got, want):
    """N(mean, std) of Input's batch by the shape attr, by its moments."""
    out = np.asarray(got["Out"][0], np.float64)
    assert out.shape == (case.inputs["Input"][0].shape[0],
                         case.attrs["shape"][1])
    assert abs(out.mean() - case.attrs["mean"]) <= 0.1
    assert abs(out.std() / case.attrs["std"] - 1.0) <= 0.1


def _v_uniform_like(case, got, want):
    out = np.asarray(got["Out"][0], np.float64)
    lo, hi = case.attrs["min"], case.attrs["max"]
    assert out.min() >= lo and out.max() <= hi
    assert abs(out.mean() - (lo + hi) / 2) <= 0.05 * (hi - lo)


def _v_random_crop(case, got, want):
    """Out is X cut at one offset of the trailing dims."""
    x, out = case.inputs["X"][0], np.asarray(got["Out"][0])
    h, w = case.attrs["shape"]
    hits = [(i, j) for i in range(x.shape[1] - h + 1)
            for j in range(x.shape[2] - w + 1)
            if np.array_equal(x[:, i:i + h, j:j + w], out)]
    assert len(hits) == 1, hits


def _v_tdm_sampler(case, got, want):
    """Positives are the items' travel nodes, each negative a node of its
    layer other than the positive, the labels and mask as laid out."""
    x = case.inputs["X"][0].reshape(-1)
    travel, layer = case.inputs["Travel"][0], case.inputs["Layer"][0]
    offs, negs = case.attrs["layer_offset_lod"], \
        case.attrs["neg_samples_num_list"]
    out, lab = np.asarray(got["Out"][0]), np.asarray(got["Labels"][0])
    col = 0
    for li, neg in enumerate(negs):
        nodes = set(layer[offs[li]:offs[li + 1]].reshape(-1).tolist())
        pos = travel[x, li]
        np.testing.assert_array_equal(out[:, col], pos)
        np.testing.assert_array_equal(lab[:, col], 1)
        for k in range(1, neg + 1):
            assert all(v in nodes and v != p
                       for v, p in zip(out[:, col + k], pos))
            np.testing.assert_array_equal(lab[:, col + k], 0)
        col += 1 + neg


def _iou_np(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt + 1, 0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda z: (z[:, 2] - z[:, 0] + 1) * (z[:, 3] - z[:, 1] + 1)
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def _v_rpn_target_assign(case, got, want):
    """The sampled anchors keep the invariants: the deterministic fg set
    (IoU >= positive or a gt's best) capped at fg_fraction, backgrounds
    below the negative IoU, the batch filled, labels 1 on fg."""
    anc, gt = case.inputs["Anchor"][0], case.inputs["GtBoxes"][0][0]
    a = case.attrs
    iou = _iou_np(anc, gt)
    fg_all = (iou.max(1) >= a["rpn_positive_overlap"]) \
        | (iou == iou.max(0)[None]).any(1)
    bg_all = (iou.max(1) < a["rpn_negative_overlap"]) & ~fg_all
    nfg = int(np.asarray(got["ForegroundNumber"][0])[0])
    nsc = int(np.asarray(got["ScoreNumber"][0])[0])
    batch = a["rpn_batch_size_per_im"]
    assert nfg == min(fg_all.sum(), int(batch * a["rpn_fg_fraction"]))
    assert nsc == min(batch, nfg + bg_all.sum())
    loc = np.asarray(got["LocationIndex"][0])[0]
    score = np.asarray(got["ScoreIndex"][0])[0]
    assert fg_all[loc[:nfg]].all() and (loc[nfg:] == -1).all()
    sampled = score[:nsc]
    assert len(set(sampled.tolist())) == nsc
    assert (fg_all | bg_all)[sampled].all()
    lbl = np.asarray(got["TargetLabel"][0])[0]
    np.testing.assert_array_equal(lbl[:nsc], fg_all[sampled].astype(int))


def _v_proposal_labels(case, got, want):
    """The sampled rois: fg (IoU >= fg_thresh) first, capped at
    fg_fraction, then bg; labels the matched gt's class on fg, 0 on bg;
    each fg target BoxToDelta of its roi against its gt."""
    a = case.attrs
    gt = case.inputs["GtBoxes"][0][0]
    cls = case.inputs["GtClasses"][0][0].reshape(-1)
    n = int(np.asarray(got["RoisNum"][0])[0])
    rois = np.asarray(got["Rois"][0])[0]
    lbl = np.asarray(got["LabelsInt32"][0])[0, :, 0]
    tgt = np.asarray(got["BboxTargets"][0])[0].reshape(
        len(rois), a["class_nums"], 4)
    iou = _iou_np(rois[:n], gt)
    fg = iou.max(1) >= a["fg_thresh"]
    nfg = int(fg.sum())
    assert nfg <= int(a["fg_fraction"] * a["batch_size_per_im"])
    assert fg[:nfg].all() and not fg[nfg:].any()
    assert (iou.max(1)[nfg:] < a["bg_thresh_hi"]).all()
    np.testing.assert_array_equal(lbl[:nfg], cls[iou[:nfg].argmax(1)])
    np.testing.assert_array_equal(lbl[nfg:], 0)
    w = a["bbox_reg_weights"]
    for r in range(nfg):
        g = gt[iou[r].argmax()]
        e = rois[r]
        ew, eh = e[2] - e[0] + 1, e[3] - e[1] + 1
        gw, gh = g[2] - g[0] + 1, g[3] - g[1] + 1
        d = [((g[0] + gw / 2) - (e[0] + ew / 2)) / ew / w[0],
             ((g[1] + gh / 2) - (e[1] + eh / 2)) / eh / w[1],
             np.log(gw / ew) / w[2], np.log(gh / eh) / w[3]]
        np.testing.assert_allclose(tgt[r, lbl[r]], d, rtol=1e-4, atol=1e-5)


def _grid_anchors(H, W, stride=4):
    base = np.array([[0, 0, 15, 15], [4, 4, 11, 11], [2, 2, 13, 13]],
                    np.float32)
    out = np.zeros((H, W, 3, 4), np.float32)
    for y in range(H):
        for x in range(W):
            out[y, x] = base + np.array([x, y, x, y]) * stride
    return out


def _pool_with_index(x):
    """2x2 max pool and each max's flat H*W index (unpool's inputs)."""
    n, c, h, w = x.shape
    win = x.reshape(n, c, h // 2, 2, w // 2, 2).transpose(0, 1, 2, 4, 3, 5) \
        .reshape(n, c, h // 2, w // 2, 4)
    arg = win.argmax(-1)
    rows = np.arange(h // 2)[:, None] * 2 + arg // 2
    cols = np.arange(w // 2)[None, :] * 2 + arg % 2
    return win.max(-1), (rows * w + cols).astype(np.int32)


_TREE = np.zeros((8, 5), np.int32)
_TREE[1:8] = [[0, 0, 0, 2, 3], [0, 1, 1, 4, 5], [0, 1, 1, 6, 7],
              [41, 2, 2, 0, 0], [42, 2, 2, 0, 0], [43, 2, 3, 0, 0],
              [44, 2, 3, 0, 0]]
_ANC8 = np.array([[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50],
                  [60, 60, 70, 70], [200, 200, 210, 210],
                  [220, 220, 230, 230], [240, 240, 250, 250],
                  [260, 260, 270, 270]], np.float32)
_GT2 = np.array([[[0, 0, 10, 10], [20, 20, 30, 30]]], np.float32)
_FPN_ROIS = np.array([[0, 0, 112, 112], [0, 0, 224, 224],
                      [0, 0, 448, 448], [0, 0, 100, 125]], np.float32)


def _boxes(n, lo=0.0, hi=60.0, size=(6.0, 20.0)):
    xy = _R.uniform(lo, hi, (n, 2))
    wh = _R.uniform(*size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# batch 2: collectives (no group bound), RNN monoliths, fusion ops
for _t in ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
           "c_allreduce_prod", "c_allgather", "c_reducescatter",
           "c_broadcast", "c_comm_init", "c_comm_init_all", "c_gen_nccl_id",
           "c_sync_calc_stream", "c_sync_comm_stream", "gen_nccl_id",
           "c_reduce_sum", "c_reduce_max", "c_reduce_min", "c_reduce_prod",
           "c_scatter", "barrier", "allreduce", "broadcast"):
    C(_t, {"X": f(3, 4)})
C("sync_batch_norm", {"X": f(4, 3, 2, 2), "Scale": f(3), "Bias": f(3),
                      "Mean": np.zeros(3, np.float32),
                      "Variance": np.ones(3, np.float32)},
  {"is_test": False, "momentum": 0.9}, outs=("Y", "MeanOut", "VarianceOut"))
_MASK = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32)
C("lstm", {"Input": f(2, 4, 12), "Weight": f(3, 12) * 0.5, "Bias": f(12)},
  outs=("Hidden", "Cell"))
C("lstm", {"Input": f(2, 4, 12), "Weight": f(3, 12) * 0.5, "Bias": f(12),
           "Mask": _MASK, "H0": f(2, 3), "C0": f(2, 3)},
  outs=("Hidden", "Cell"), name="mask")
C("lstmp", {"Input": f(2, 4, 12), "Weight": f(2, 12) * 0.5,
            "ProjWeight": f(3, 2), "Bias": f(12), "Mask": _MASK},
  outs=("Projection", "Cell"))
C("cudnn_lstm", {"Input": f(4, 2, 3), "W": f(48) * 0.5},
  {"hidden_size": 2}, outs=("Out", "LastH", "LastC"))
C("gru", {"Input": f(2, 4, 9), "Weight": f(3, 9) * 0.5, "Bias": f(9),
          "Mask": _MASK}, outs=("Hidden",))
C("fusion_lstm", {"X": f(2, 4, 5), "WeightX": f(5, 12) * 0.5,
                  "WeightH": f(3, 12) * 0.5, "Bias": f(12)},
  outs=("Hidden", "Cell"))
C("fusion_gru", {"X": f(2, 4, 5), "WeightX": f(5, 9) * 0.5,
                 "WeightH": f(3, 9) * 0.5, "Bias": f(9)}, outs=("Hidden",))
C("fused_embedding_fc_lstm", {"Ids": i(2, 4, hi=11),
                              "Embeddings": f(11, 12) * 0.5,
                              "WeightH": f(3, 12) * 0.5, "Bias": f(12)},
  outs=("Hidden", "Cell"))
C("fusion_repeated_fc_relu", {"X": f(3, 4), "W": [f(4, 5), f(5, 2)],
                              "Bias": [f(5), f(2)]})
C("fusion_squared_mat_sub", {"X": f(3, 4), "Y": f(4, 5)}, {"scalar": 0.5})
_LEN2 = np.array([5, 3], np.int32)
C("fusion_seqpool_concat", {"X": [f(2, 5, 3), f(2, 5, 3)],
                            "Length": _LEN2}, {"pooltype": "SUM"})
C("fusion_seqconv_eltadd_relu", {"X": f(2, 5, 3), "Length": _LEN2,
                                 "Filter": f(9, 4), "Bias": f(4)},
  {"contextLength": 3, "contextStart": -1})
C("max_pool3d_with_index", {"X": f(1, 2, 4, 4, 4)},
  {"ksize": [2, 2, 2], "strides": [2, 2, 2]}, outs=("Out", "Mask"))
_PV, _PI = _pool_with_index(f(1, 2, 4, 4))
C("unpool", {"X": _PV, "Indices": _PI}, {"output_size": [4, 4]})
# tensor arrays: a list in the environment, stacked back to be fetched
C("write_to_array", {"X": f(2, 3)}, {"index": 0},
  post=[("array_to_lod_tensor", {"X": ["out_out_0"]}, {"Out": ["stk"]},
         {})])
C("read_from_array", {"X": "arr"}, {"index": 1}, feeds={"seq": f(3, 2)},
  pre=[("lod_tensor_to_array", {"X": ["seq"]}, {"Out": ["arr"]}, {})])
C("array_to_lod_tensor", {"X": "arr"}, feeds={"seq": f(3, 2)},
  pre=[("lod_tensor_to_array", {"X": ["seq"]}, {"Out": ["arr"]}, {})])
C("lod_tensor_to_array", {"X": f(3, 2)},
  post=[("array_to_lod_tensor", {"X": ["out_out_0"]}, {"Out": ["stk"]},
         {})])
C("shrink_rnn_memory", {"X": f(2, 3)})
_M4 = np.array([1, 0, 1, 0], np.int32)
C("merge_lod_tensor", {"InTrue": f(4, 3), "InFalse": f(4, 3), "Mask": _M4})
C("merge_lod_tensor_infer", {"InTrue": f(4, 3), "InFalse": f(4, 3),
                             "Mask": _M4})
C("split_lod_tensor", {"X": f(4, 3), "Mask": _M4},
  outs=("OutTrue", "OutFalse"))
# PS data plane: a fresh seeded table per run in each package
_IDS = np.array([[3, 5, 3]], np.int32)
C("distributed_lookup_table", {"Ids": _IDS}, {"table_name": "emb"},
  outs=("Outputs",), bind=_ps_table)
for _t in ("pull_sparse", "pull_sparse_v2"):
    C(_t, {"Ids": _IDS}, {"table_name": "emb"}, bind=_ps_table)
for _t in ("push_sparse", "push_sparse_v2"):
    C(_t, {"Ids": np.array([3, 5], np.int32), "Grads": f(2, 4)},
      {"table_name": "emb", "lr": 0.5}, bind=_ps_table)
C("c_embedding", {"Ids": i(2, 3, hi=10), "W": f(5, 4)}, {"start_index": 3})
_SA = np.array([0, -1, 2, -1, 4, -1], np.int32)
_SB = np.array([-1, 1, -1, 3, -1, 5], np.int32)
C("merge_ids", {"Ids": [_SA, _SB], "X": [f(6, 2), f(6, 2)]})
C("split_ids", {"Ids": np.arange(6, dtype=np.int32)}, outs={"Out": 2})
C("split_selected_rows", {"X": f(5, 2)}, {"height_sections": [2, 3]},
  outs={"Out": 2})
C("split_byref", {"X": f(4, 3)}, outs={"Out": 2})
C("lookup_sparse_table_merge", {"X": [i(4, hi=6), i(3, hi=6)]})
C("print", {"In": f(2, 3)}, {"message": "print op: "})
C("quantize", {"Input": f(2, 3)}, {"scale": 60.0}, outs=("Output",))
_Q8 = i(2, 3, lo=-128, hi=128).astype(np.int8)
C("dequantize", {"Input": _Q8}, {"scale": 60.0}, outs=("Output",))
C("requantize", {"Input": _Q8}, {"Scale_in": 100.0, "Scale_out": 50.0},
  outs=("Output",))

# batch 3: contrib / detection stragglers
C("attention_lstm", {"X": f(2, 4, 3), "AttentionWeight": f(5, 1),
                     "AttentionBias": f(1), "AttentionScalar": f(1),
                     "AttentionScalarBias": f(1), "LSTMWeight": f(5, 8) * .5,
                     "LSTMBias": f(8), "Mask": _MASK},
  outs=("Hidden", "Cell"))
C("tree_conv", {"NodesVector": f(1, 5, 3),
                "EdgeSet": np.array([[[0, 1], [0, 2], [1, 3], [1, 4],
                                      [-1, -1]]], np.int32),
                "Filter": f(3, 3, 2, 2)}, {"max_depth": 2})
_PH = i(2, 5, hi=20)
_PH[1, 3:] = -1
C("pyramid_hash", {"X": _PH, "W": f(32, 4)},
  {"space_len": 32, "pyramid_layer": 3, "num_emb": 4})
C("var_conv_2d", {"X": f(2, 2, 5, 5), "ROW": np.array([5, 3], np.int32),
                  "COLUMN": np.array([4, 5], np.int32), "W": f(3, 2, 3, 3)},
  {"StrideH": 1, "StrideW": 1, "KernelH": 3, "KernelW": 3}, tol=1e-4)
C("bilateral_slice", {"X": f(1, 2, 4, 4), "Grid": f(1, 6, 3, 2, 2),
                      "Guide": f(1, 4, 4, lo=0, hi=1)}, {"has_offset": True})
C("bilateral_slice", {"X": f(1, 2, 4, 4), "Grid": f(1, 4, 3, 2, 2),
                      "Guide": f(1, 4, 4, lo=0, hi=1)},
  {"has_offset": False}, name="no_offset")
C("sequence_reshape", {"X": f(2, 4, 6)}, {"new_dim": 8})
C("sequence_scatter", {"X": f(2, 5, 3),
                       "Ids": np.array([[0, 3], [1, 1]], np.int32),
                       "Updates": f(2, 2, 3)})
C("select_input", {"X": [f(2, 3), f(2, 3)], "Mask": np.array([1], np.int32)})
C("select_output", {"X": f(2, 3), "Mask": np.array([1], np.int32)},
  outs={"Out": 2})
C("fusion_seqexpand_concat_fc", {"X": [f(2, 4, 3), f(2, 2)],
                                 "FCWeight": f(5, 4), "FCBias": f(4)},
  {"fc_activation": "relu"})

# batch 4: padded dynamic outputs, hashing, optimizers, DGC
_U = np.array([3, 1, 3, 0, 1, 4, 4, 3], np.int32)
C("unique", {"X": _U}, {"dtype": "int32"},
  outs=("Out", "Index", "Counts", "ValidCount"))
C("unique_with_counts", {"X": _U}, {"dtype": "int32"},
  outs=("Out", "Index", "Count", "ValidCount"))
C("where_index", {"Condition": b(3, 4)}, outs=("Out", "ValidCount"))
C("hash", {"X": i(4, 2, hi=100)}, {"num_hash": 3, "mod_by": 1000})
C("sequence_enumerate", {"X": i(2, 5, hi=9), "Length": _LEN2},
  {"win_size": 3, "pad_value": 0})
C("sequence_erase", {"X": i(2, 6, hi=6),
                     "Length": np.array([6, 4], np.int32)},
  {"tokens": [2, 3]}, outs=("Out", "Length"))
C("proximal_adagrad", {**_OPT, "Moment": f(3, 4, lo=0.1, hi=1)},
  {"l1": 0.05, "l2": 0.01}, outs=("ParamOut", "MomentOut"))
C("proximal_gd", _OPT, {"l1": 0.05, "l2": 0.01}, outs=("ParamOut",))
C("positive_negative_pair", {"Score": f(8, 2),
                             "Label": i(8, 1, hi=3).astype(np.float32),
                             "QueryID": i(8, 1, hi=2)},
  {"column": -1}, outs=("PositivePair", "NegativePair", "NeutralPair"))
_DGC = {"U": f(4, 4), "V": f(4, 4), "Grad": f(4, 4), "Param": f(4, 4),
        "current_step": _a(5.0), "nranks": _a(1.0)}
C("dgc", _DGC, {"m": 0.9, "sparsity": [0.75], "rampup_begin_step": 0.0,
                "rampup_step": 1.0, "regular_coeff": 0.01,
                "regular_type": 2},
  outs=("U_out", "V_out", "EncodeGrad", "Grad_out", "k", "GatherBuff"))
C("dgc_momentum", {**_OPT, "Velocity": f(3, 4), "current_step": _a(5.0),
                   "nranks": _a(2.0)}, {"mu": 0.9, "rampup_begin_step": 10},
  outs=("ParamOut", "VelocityOut", "Grad_out"))
C("dgc_clip_by_norm", {"X": f(3, 4), "current_step": _a(5.0)},
  {"max_norm": 1.0, "rampup_begin_step": 0})

# batch 5: aliases and the numeric tail
_X34 = f(3, 4)
C("allclose", {"Input": _X34, "Other": _X34 + 1e-7})
C("allclose", {"Input": _X34, "Other": _X34 + 0.1}, name="far")
C("bernoulli", {"X": f(64, 64, lo=0, hi=1)}, random=True,
  verify=_v_bernoulli)
C("eye", {}, {"num_rows": 3, "num_columns": 4})
C("fill", {}, {"value": [1, 2, 3, 4, 5, 6], "shape": [2, 3],
               "dtype": "float32"})
C("fill_zeros_like2", {"X": f(2, 3)})
C("diag_v2", {"X": f(3)}, {"offset": 1, "padding_value": 0.5})
C("diag_v2", {"X": f(3, 4)}, {"offset": -1}, name="2d")
C("diag_embed", {"X": f(2, 3)}, {"offset": 1})
C("histogram", {"X": f(50)}, {"bins": 10})
C("histogram", {"X": f(50)}, {"bins": 8, "min": -1, "max": 1},
  name="range")
C("randint", {}, {"shape": [40, 40], "low": 0, "high": 10},
  random=True, verify=_v_int_range(0, 9))
C("randperm", {}, {"n": 1200}, random=True, verify=_v_randperm)
_PROBS = f(2000, 5, lo=0.1, hi=1)
C("sampling_id", {"X": _PROBS / _PROBS.sum(1, keepdims=True)}, random=True,
  verify=_v_sampling_id)
C("seed", {}, {"seed": 7})
C("seed", {}, {"seed": 0}, name="draw", random=True, verify=_v_seed)
C("modified_huber_loss", {"X": f(6, 1) * 2,
                          "Y": i(6, 1, hi=2).astype(np.float32)},
  outs=("IntermediateVal", "Out"))
C("add_position_encoding", {"X": f(2, 4, 6)}, {"alpha": 0.5, "beta": 1.5})
C("add_position_encoding", {"X": f(2, 3, 5)}, name="odd")
C("amp_check_finite_and_scale", {"X": [f(2, 3), f(3)], "Scale": _a(2.0)},
  outs={"Out": 2, "FoundInfinite": 1})
C("amp_check_finite_and_scale",
  {"X": [np.array([1.0, np.inf], np.float32)], "Scale": _a(2.0)},
  outs=("Out", "FoundInfinite"), name="inf")
C("fake_init", {}, {"shape": [2, 3]})
C("bilinear_tensor_product", {"X": f(3, 4), "Y": f(3, 5),
                              "Weight": f(2, 4, 5), "Bias": f(1, 2)})
C("gaussian_random_batch_size_like", {"Input": f(40, 3)},
  {"shape": [-1, 30], "mean": 1.0, "std": 2.0}, random=True,
  verify=_v_normal_like)
C("uniform_random_batch_size_like", {"Input": f(40, 3)},
  {"shape": [-1, 30], "min": -2.0, "max": 3.0}, random=True,
  verify=_v_uniform_like)
C("sequence_expand_as", {"X": f(2, 3), "Y": f(2, 4, 3),
                         "Length": np.array([4, 2], np.int32)})
_QF = np.round(f(3, 4) * 40).astype(np.float32)
for _t in ("fake_dequantize_max_abs", "dequantize_abs_max"):
    C(_t, {"X": _QF, "Scale": _a(2.0)}, {"max_range": 127.0})
C("fake_channel_wise_dequantize_max_abs",
  {"X": _QF, "Scales": [f(3, lo=0.5, hi=2)]},
  {"quant_axis": 0, "quant_bits": [8]})
C("dequantize_log", {"X": i(3, 4, lo=-128, hi=128).astype(np.int8),
                     "Dict": f(128)})
C("fake_quantize_moving_average_abs_max",
  {"X": _X, "InScale": _a(0.8), "InState": _a(1.0), "InAccum": _a(0.8)},
  {"moving_rate": 0.9}, outs=("Out", "OutScale", "OutState", "OutAccum"))
C("average_accumulates", {"param": f(3), "in_sum_1": f(3),
                          "in_sum_2": f(3), "in_sum_3": f(3),
                          "in_num_updates": np.array([5], np.int32),
                          "in_num_accumulates": np.array([3], np.int32),
                          "in_old_num_accumulates": np.array([0], np.int32)},
  {"average_window": 0.5, "max_average_window": 10,
   "min_average_window": 2},
  outs=("out_sum_1", "out_sum_2", "out_sum_3", "out_num_updates",
        "out_num_accumulates", "out_old_num_accumulates"))
C("precision_recall", {"Indices": i(6, 1, hi=3), "Labels": i(6, 1, hi=3),
                       "Weights": f(6, 1, lo=0.5, hi=1.5),
                       "StatesInfo": f(3, 4, lo=0, hi=3)},
  {"class_number": 3},
  outs=("BatchMetrics", "AccumMetrics", "AccumStatesInfo"))
C("spp", {"X": f(1, 2, 5, 5)}, {"pyramid_height": 2, "pooling_type": "max"})
C("spp", {"X": f(1, 2, 5, 5)}, {"pyramid_height": 2, "pooling_type": "avg"},
  name="avg")
C("polygon_box_transform", {"Input": f(1, 4, 3, 3)}, outs=("Output",))
C("random_crop", {"X": f(2, 40, 40)}, {"shape": [30, 30]},
  outs=("Out", "SeedOut"), random=True, verify=_v_random_crop)
C("hierarchical_sigmoid", {"X": f(4, 3), "W": f(5, 3),
                           "Label": i(4, 1, hi=6), "Bias": f(5)},
  {"num_classes": 6}, outs=("Out", "PreOut"))
_DIST = f(1, 3, 5, lo=0, hi=1)
C("bipartite_match", {"DistMat": _DIST},
  outs=("ColToRowMatchIndices", "ColToRowMatchDist"))
C("bipartite_match", {"DistMat": _DIST},
  {"match_type": "per_prediction", "dist_threshold": 0.5},
  outs=("ColToRowMatchIndices", "ColToRowMatchDist"), name="per_pred")
C("target_assign", {"X": f(2, 4, 3), "MatchIndices": i(2, 5, lo=-1, hi=4),
                    "NegIndices": np.array([[1, 3, -1, -1, -1],
                                            [0, -1, -1, -1, -1]], np.int32)},
  {"mismatch_value": 0}, outs=("Out", "OutWeight"))
_MHE = {"ClsLoss": f(2, 6), "LocLoss": f(2, 6),
        "MatchIndices": i(2, 6, lo=-1, hi=2),
        "MatchDist": f(2, 6, lo=0, hi=1)}
C("mine_hard_examples", _MHE, {"neg_pos_ratio": 1.0},
  outs=("NegIndices", "UpdatedMatchIndices"))
C("mine_hard_examples", _MHE, {"mining_type": "hard_example",
                               "sample_size": 3, "neg_dist_threshold": 0.5},
  outs=("NegIndices", "UpdatedMatchIndices"), name="hard")
C("assert", {"Cond": np.array([True, True]), "Data": [f(3)]}, outs=())

# batch 6: the RCNN / FPN tail
_GA = _grid_anchors(4, 4)
C("generate_proposals",
  {"Scores": f(2, 3, 4, 4, lo=0, hi=1), "BboxDeltas": f(2, 12, 4, 4) * 0.1,
   "ImInfo": np.array([[64, 64, 1], [60, 56, 1]], np.float32),
   "Anchors": _GA, "Variances": np.ones_like(_GA)},
  {"pre_nms_topN": 48, "post_nms_topN": 8, "nms_thresh": 0.7,
   "min_size": 1.0}, outs=("RpnRois", "RpnRoiProbs", "RpnRoisNum"))
_RPN = {"rpn_batch_size_per_im": 6, "rpn_positive_overlap": 0.7,
        "rpn_negative_overlap": 0.3, "rpn_fg_fraction": 0.5}
_RPN_OUTS = ("LocationIndex", "ScoreIndex", "TargetLabel", "TargetBBox",
             "MatchedGtIndex", "BBoxInsideWeight", "ForegroundNumber",
             "ScoreNumber")
C("rpn_target_assign", {"Anchor": _ANC8, "GtBoxes": _GT2},
  {**_RPN, "use_random": False}, outs=_RPN_OUTS)
_ANC_R = np.concatenate([_ANC8, _boxes(40)])
C("rpn_target_assign", {"Anchor": _ANC_R, "GtBoxes": _GT2},
  {**_RPN, "rpn_batch_size_per_im": 12, "use_random": True},
  outs=_RPN_OUTS, name="random", random=True, verify=_v_rpn_target_assign)
_NMS_BOX = _boxes(12, 10, 80)[None]
for _g in (False, True):
    C("matrix_nms", {"BBoxes": _NMS_BOX, "Scores": f(1, 3, 12, lo=0, hi=1)},
      {"score_threshold": 0.2, "post_threshold": 0.1, "nms_top_k": 12,
       "keep_top_k": 20, "use_gaussian": _g, "gaussian_sigma": 2.0,
       "background_label": 0, "normalized": False},
      outs=("Out", "Index", "RoisNum"), name="gauss" if _g else "")
C("box_decoder_and_assign",
  {"PriorBox": _boxes(4), "PriorBoxVar": _a(0.1, 0.1, 0.2, 0.2),
   "TargetBox": f(4, 12) * 0.5, "BoxScore": f(4, 3, lo=0, hi=1)},
  {"box_clip": 4.135}, outs=("DecodeBox", "OutputAssignBox"))
_FPN_ALL = np.concatenate([_FPN_ROIS, _boxes(6, 0, 300, (8, 400)),
                           np.zeros((2, 4), np.float32)])
C("distribute_fpn_proposals", {"FpnRois": _FPN_ALL},
  {"min_level": 2, "max_level": 5, "refer_level": 4, "refer_scale": 224},
  outs={"MultiFpnRois": 4, "MultiLevelRoIsNum": 1, "RestoreIndex": 1})
C("collect_fpn_proposals",
  {"MultiLevelRois": [_boxes(4), _boxes(4), _boxes(4)],
   "MultiLevelScores": [f(4, lo=0, hi=1), f(4, lo=0, hi=1),
                        f(4, lo=0, hi=1)],
   "MultiLevelRoIsNum": np.array([2, 4, 1], np.int32)},
  {"post_nms_topN": 5}, outs=("FpnRois", "RoisNum"))

# batch 7: TDM, text matching, RetinaNet, deformable PS-RoI, the
# proposal-target layer, the perspective transform
C("tdm_child", {"X": np.array([[1], [3], [4], [0]], np.int32),
                "TreeInfo": _TREE}, {"child_nums": 2},
  outs=("Child", "LeafMask"))
C("tdm_sampler", {"X": np.array([[0], [1]] * 8, np.int32),
                  "Travel": np.array([[2, 4], [3, 6]], np.int32),
                  "Layer": np.array([2, 3, 4, 5, 6, 7], np.int32)},
  {"neg_samples_num_list": [1, 2], "layer_offset_lod": [0, 2, 6],
   "output_positive": True}, outs=("Out", "Labels", "Mask"), random=True,
  verify=_v_tdm_sampler)
C("match_matrix_tensor", {"X": f(2, 3, 4), "Y": f(2, 2, 4),
                          "W": f(4, 2, 4),
                          "XLength": np.array([3, 2], np.int32),
                          "YLength": np.array([2, 1], np.int32)},
  {"dim_t": 2}, outs=("Out", "Tmp"))
C("sequence_topk_avg_pooling", {"X": f(2, 2, 3, 5),
                                "RowLength": np.array([3, 2], np.int32),
                                "ColLength": np.array([5, 4], np.int32)},
  {"topks": [1, 3], "channel_num": 2}, outs=("Out", "pos"))
C("retinanet_target_assign", {"Anchor": _ANC8, "GtBoxes": _GT2,
                              "GtLabels": np.array([[[3], [5]]], np.int32)},
  {"positive_overlap": 0.5, "negative_overlap": 0.4},
  outs=("LocationIndex", "ScoreIndex", "TargetLabel", "TargetBBox",
        "BBoxInsideWeight", "ForegroundNumber", "ScoreNumber"))
_DPS = {"spatial_scale": 1.0, "output_dim": 2, "group_size": [2, 2],
        "pooled_height": 2, "pooled_width": 2, "part_size": [2, 2],
        "sample_per_part": 4}
_DPS_ROIS = np.array([[0, 1, 1, 4, 4], [0, 0, 2, 5, 5]], np.float32)
C("deformable_psroi_pooling", {"Input": f(1, 8, 6, 6), "ROIs": _DPS_ROIS},
  {**_DPS, "no_trans": True, "trans_std": 0.0},
  outs=("Output", "TopCount"), tol=1e-4)
C("deformable_psroi_pooling", {"Input": f(1, 8, 6, 6), "ROIs": _DPS_ROIS,
                               "Trans": f(2, 2, 2, 2) * 0.5},
  {**_DPS, "no_trans": False, "trans_std": 0.1},
  outs=("Output", "TopCount"), name="trans", tol=1e-4)
_GPL_ROIS = np.array([[[0, 0, 10, 10], [100, 100, 120, 120],
                       [40, 40, 60, 60], [1, 1, 11, 12]]], np.float32)
_GPL_GT = np.array([[[0, 0, 10, 10], [30, 30, 50, 50]]], np.float32)
_GPL = {"batch_size_per_im": 4, "fg_fraction": 0.5, "fg_thresh": 0.5,
        "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0, "class_nums": 7,
        "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2]}
_GPL_OUTS = ("Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
             "BboxOutsideWeights", "RoisNum")
C("generate_proposal_labels",
  {"RpnRois": _GPL_ROIS, "GtClasses": np.array([[[2], [5]]], np.int32),
   "IsCrowd": np.zeros((1, 2), np.int32), "GtBoxes": _GPL_GT,
   "ImInfo": np.array([[100, 100, 1.0]], np.float32),
   "RpnRoisNum": np.array([4], np.int32)},
  {**_GPL, "use_random": False}, outs=_GPL_OUTS)
_GPL_R = np.concatenate([_GPL_ROIS[0], _boxes(30, 0, 50)])[None]
C("generate_proposal_labels",
  {"RpnRois": _GPL_R, "GtClasses": np.array([[[2], [5]]], np.int32),
   "GtBoxes": _GPL_GT, "ImInfo": np.array([[100, 100, 1.0]], np.float32)},
  {**_GPL, "batch_size_per_im": 12, "use_random": True}, outs=_GPL_OUTS,
  name="random", random=True, verify=_v_proposal_labels)
C("retinanet_detection_output",
  {"BBoxes": [f(1, 6, 4) * 0.1, f(1, 4, 4) * 0.1],
   "Scores": [f(1, 6, 2, lo=0, hi=1), f(1, 4, 2, lo=0, hi=1)],
   "Anchors": [_boxes(6), _boxes(4)],
   "ImInfo": np.array([[100, 100, 1.0]], np.float32)},
  {"score_threshold": 0.3, "nms_top_k": 6, "nms_threshold": 0.3,
   "keep_top_k": 5}, outs=("Out", "RoisNum"))
C("roi_perspective_transform",
  {"X": f(1, 2, 8, 8),
   "ROIs": np.array([[0, 1, 1, 6, 1.5, 6.5, 5, 1, 5.5]], np.float32)},
  {"transformed_height": 4, "transformed_width": 5, "spatial_scale": 1.0},
  outs=("Out", "Mask", "TransformMatrix"), tol=1e-4)


_OPTEST_MODULES = ("tests.test_op_harness", "tests.test_ops_tail",
                   "tests.test_ops_tail2", "tests.test_ops_tail3",
                   "tests.test_ops_tail5")


def _optest_cases(registered) -> List[Case]:
    from tests.op_test_base import OpTest

    out = []
    for mod_name in _OPTEST_MODULES:
        mod = importlib.import_module(mod_name)
        for cls_name, cls in sorted(vars(mod).items()):
            if not (inspect.isclass(cls) and issubclass(cls, OpTest)
                    and cls is not OpTest):
                continue
            t = cls()
            t.setup_method()
            if t.op_type not in registered:
                continue
            outs = {slot: len(v) if isinstance(v, (list, tuple)) else 1
                    for slot, v in t.outputs.items()}
            out.append(Case(t.op_type, t.inputs, t.attrs, outs,
                            name=cls_name, tol=1e-4))
    return out


def cases(registered) -> List[Case]:
    """Every case: the OpTest-declared ones for the op types in
    ``registered``, then the hand-written table."""
    return _optest_cases(registered) + [c for c in HAND
                                        if c.op_type in registered]


def _py_double(x):
    return np.asarray(x) * 2.0 + 1.0


_PY_FUNC_ID = 7001


def _fill(attrs, tmp):
    out = {}
    for k, v in attrs.items():
        if v == "{py_func}":
            v = _PY_FUNC_ID
        elif isinstance(v, str) and "{tmp}" in v:
            v = v.replace("{tmp}", str(tmp))
        out[k] = v
    return out


def run(case: Case, static, tmp, place=None, seed: int = 1):
    """Build ``case`` as a one-op program of the package ``static``
    (``paddle_tpu.static`` or ``paddle_tpu_torch.static``) and run it:
    returns ({slot: [numpy arrays]}, {file name: numpy arrays} for the
    files a save op wrote)."""
    import os

    if case.op_type == "py_func":
        importlib.import_module(static.__name__ + ".ops_tail2") \
            .register_py_func(_PY_FUNC_ID, _py_double)
    os.makedirs(tmp, exist_ok=True)
    if case.prep is not None:
        case.prep(tmp)
    if case.bind is not None:
        case.bind(static)
    main = static.Program()
    main.random_seed = seed
    blk = main.global_block()
    feed, ins = {}, {}
    for name, arr in case.feeds.items():
        blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype),
                       is_data=True)
        feed[name] = arr
    for slot, arrs in case.inputs.items():
        names = []
        for k, arr in enumerate(arrs):
            if isinstance(arr, str):
                names.append(arr)
                continue
            name = f"{slot.lower()}_{k}"
            blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype),
                           is_data=True)
            feed[name] = arr
            names.append(name)
        ins[slot] = names

    def declare(names_by_slot):
        for names in names_by_slot.values():
            for name in names:
                if not blk.has_var(name):
                    blk.create_var(name=name, shape=(), dtype="float32")

    for op_type, op_ins, op_outs, op_attrs in case.pre:
        declare(op_outs)
        blk.append_op(op_type, op_ins, op_outs, dict(op_attrs))
    outs = {slot: [f"out_{slot.lower()}_{k}" for k in range(n)]
            for slot, n in case.outs.items()}
    declare(outs)
    blk.append_op(case.op_type, ins, outs, _fill(case.attrs, tmp))
    for op_type, op_ins, op_outs, op_attrs in case.post:
        declare(op_outs)
        blk.append_op(op_type, op_ins, op_outs, dict(op_attrs))
    if case.post:
        outs = case.post[-1][2]
    exe = static.Executor() if place is None else static.Executor(place)
    fetch = [n for names in outs.values() for n in names]
    guard = contextlib.nullcontext()
    if place is not None:
        import paddle_tpu_torch

        guard = paddle_tpu_torch.device_guard(place)
    with guard:
        got = exe.run(main, feed=feed, fetch_list=fetch,
                      scope=static.Scope())
    by_slot, k = {}, 0
    for slot, names in outs.items():
        by_slot[slot] = [np.asarray(g) for g in got[k:k + len(names)]]
        k += len(names)
    files = {}
    for name in sorted(os.listdir(tmp)):
        if name.startswith("in."):
            continue
        data = np.load(os.path.join(tmp, name))
        files[name] = ({n: data[n] for n in data.files}
                       if hasattr(data, "files") else data)
    return by_slot, files


def assert_same(case: Case, got: Dict, want: Dict) -> None:
    """``got`` (the port's) against ``want`` (the JAX package's, or the
    case's expectation) under the table's tolerances."""
    for slot, wants in want.items():
        for k, w in enumerate(wants):
            g = np.asarray(got[slot][k])
            w = np.asarray(w)
            where = f"{case.id} {slot}[{k}]"
            assert g.shape == w.shape, (where, g.shape, w.shape)
            if w.dtype.kind == "V":
                assert g.tobytes() == w.tobytes(), where
                continue
            assert g.dtype.kind == w.dtype.kind or {g.dtype.kind,
                                                    w.dtype.kind} <= {"i",
                                                                      "u"}, \
                (where, g.dtype, w.dtype)
            if case.random:
                continue
            if w.dtype.kind in "iub":
                np.testing.assert_array_equal(g, w, err_msg=where)
                continue
            finite = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(g), finite,
                                          err_msg=where)
            if not finite.all():
                np.testing.assert_array_equal(g[~finite], w[~finite],
                                              err_msg=where)
            if finite.any():
                scale = float(np.abs(w[finite]).max())
                err = float(np.abs(g[finite] - w[finite]).max())
                assert err <= case.tol * max(scale, 1e-6), \
                    (where, err, scale)


def _moments_agree(g, w):
    g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
    if w.size < 1000:
        return True
    sd = w.std()
    return (abs(g.mean() - w.mean()) <= 0.15 * sd + 1e-6
            and abs(g.std() / max(sd, 1e-12) - 1.0) <= 0.15)


def check(case: Case, tmp) -> None:
    """The port's fetches (and written files) against the JAX package's."""
    import paddle_tpu.static as jstatic
    import paddle_tpu_torch.static as tstatic

    got, got_files = run(case, tstatic, tmp / "torch", place="cpu")
    if case.expect is not None:
        expect = case.expect() if callable(case.expect) else case.expect
        assert_same(case, got, expect)
        return
    want, want_files = run(case, jstatic, tmp / "jax")
    assert_same(case, got, want)
    assert sorted(got_files) == sorted(want_files)
    for name, w in want_files.items():
        g = got_files[name]
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        else:
            np.testing.assert_array_equal(g, w)
    if case.random:
        for slot, wants in want.items():
            for g, w in zip(got[slot], wants):
                if np.asarray(w).dtype.kind == "f":
                    assert _moments_agree(g, w), (case.id, slot)
        if case.verify is not None:
            case.verify(case, got, want)
        again, _ = run(case, tstatic, tmp / "again", place="cpu")
        other, _ = run(case, tstatic, tmp / "other", place="cpu", seed=7)
        flat = lambda d: [a for slot in sorted(d) for a in d[slot]]
        for a, c in zip(flat(got), flat(again)):
            np.testing.assert_array_equal(a, c)
        assert any(not np.array_equal(a, c)
                   for a, c in zip(flat(got), flat(other))), case.id


def part(k: int, n: int):
    """Every ``n``-th case from the ``k``-th, as pytest params."""
    import pytest

    import paddle_tpu_torch.static.executor  # noqa: F401 — registers ops
    from paddle_tpu_torch.static.registry import registered_ops

    every = sorted(cases(set(registered_ops())), key=lambda c: c.id)
    return [pytest.param(c, id=c.id) for c in every[k::n]]
