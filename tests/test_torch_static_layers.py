"""The whole ``static.layers`` DSL in both packages: each of the JAX
module's public names exists in the port, and each builder, called the
same way in each package, appends the same op sequence (types, input and
output slots, attrs, in every block, variable names matched by first
appearance) to the main and startup programs."""
import re

import numpy as np
import pytest

import paddle_tpu.static as jstatic
import paddle_tpu_torch.static as tstatic

_DT = re.compile(r"(bfloat16|float16|float32|float64|int8|int16|int32|"
                 r"int64|uint8|bool)")


def _canon_prog(program):
    names = {}

    def name(n):
        return names.setdefault(n, f"v{len(names)}")

    def canon(v):
        if isinstance(v, (list, tuple)):
            return [canon(x) for x in v]
        if isinstance(v, str):
            return name(v) if v in all_vars else v
        if isinstance(v, (bool, int, float)) or v is None:
            return v
        m = _DT.search(str(v))
        return m.group(1) if m else str(v)

    all_vars = {n for blk in program.blocks for n in blk.vars}
    out = []
    for blk in program.blocks:
        for op in blk.ops:
            out.append((blk.idx, op.type,
                        {s: [name(n) for n in ns]
                         for s, ns in sorted(op.inputs.items())},
                        {s: [name(n) for n in ns]
                         for s, ns in sorted(op.outputs.items())},
                        {k: canon(v) for k, v in sorted(op.attrs.items())
                         if k != "forward_callable_id"}))
    return out


class _Vars:
    def __init__(self, L):
        d = L.data
        self.x = d("x", [4], "float32")
        self.y = d("y", [4], "float32")
        self.x1 = d("x1", [1], "float32")
        self.y1 = d("y1", [1], "float32")
        self.img = d("img", [3, 8, 8], "float32")
        self.img4 = d("img4", [4, 8, 8], "float32")
        self.vol = d("vol", [2, 4, 4, 4], "float32")
        self.seq = d("seq", [5, 4], "float32")
        self.lens = d("lens", [], "int32")
        self.ids = d("ids", [1], "int64")
        self.ids3 = d("ids3", [3], "int64")
        self.lab = d("lab", [1], "int64")
        self.b1 = d("b1", [4], "bool")
        self.b2 = d("b2", [4], "bool")
        self.boxes = d("boxes", [4], "float32")
        self.rois = d("rois", [4], "float32")
        self.tmaj = d("tmaj", [2, 4], "float32")      # (T, B=2, 4)
        self.theta = d("theta", [2, 3], "float32")
        self.grid = d("grid", [4, 4, 2], "float32")
        self.iminfo = d("iminfo", [3], "float32",
                        append_batch_size=False)
        self.w34 = d("w34", [3, 4], "float32", append_batch_size=False)
        self.idx2 = d("idx2", [2], "int32", append_batch_size=False)


def _py_identity(x):
    return x


# name -> call(L, S, v); the framework re-exports and modules are checked
# by identity of kind
CALLS = {
    "abs": lambda L, S, v: L.abs(v.x),
    "accuracy": lambda L, S, v: L.accuracy(L.softmax(v.x), v.lab),
    "acos": lambda L, S, v: L.acos(v.x),
    "add_position_encoding": lambda L, S, v: L.add_position_encoding(
        v.seq, 0.5, 0.5),
    "affine_channel": lambda L, S, v: L.affine_channel(
        v.img, L.create_parameter([3]), L.create_parameter([3])),
    "affine_grid": lambda L, S, v: L.affine_grid(v.theta, [1, 2, 4, 4]),
    "argmax": lambda L, S, v: L.argmax(v.x, 1),
    "argmin": lambda L, S, v: L.argmin(v.x, 0),
    "argsort": lambda L, S, v: L.argsort(v.x, 1, True),
    "asin": lambda L, S, v: L.asin(v.x),
    "atan": lambda L, S, v: L.atan(v.x),
    "batch_norm": lambda L, S, v: L.batch_norm(v.img, act="relu"),
    "box_clip": lambda L, S, v: L.box_clip(v.boxes, v.iminfo),
    "box_coder": lambda L, S, v: L.box_coder(v.boxes, v.boxes, v.boxes,
                                             "decode_center_size"),
    "bpr_loss": lambda L, S, v: L.bpr_loss(v.x, v.lab),
    "brelu": lambda L, S, v: L.brelu(v.x),
    "cast": lambda L, S, v: L.cast(v.x, "int32"),
    "ceil": lambda L, S, v: L.ceil(v.x),
    "center_loss": lambda L, S, v: L.center_loss(v.x, v.lab, 5, 0.1),
    "chunk_eval": lambda L, S, v: L.chunk_eval(v.ids3, v.ids3, "IOB", 2),
    "clip": lambda L, S, v: L.clip(v.x, -1.0, 1.0),
    "clip_by_norm": lambda L, S, v: L.clip_by_norm(v.x, 1.0),
    "concat": lambda L, S, v: L.concat([v.x, v.y], 1),
    "conv2d": lambda L, S, v: L.conv2d(v.img, 4, 3, padding=1, act="relu"),
    "conv2d_transpose": lambda L, S, v: L.conv2d_transpose(v.img, 2, 3,
                                                           stride=2),
    "conv3d": lambda L, S, v: L.conv3d(v.vol, 3, 3, padding=1),
    "conv3d_transpose": lambda L, S, v: L.conv3d_transpose(v.vol, 3, 2),
    "cos": lambda L, S, v: L.cos(v.x),
    "cos_sim": lambda L, S, v: L.cos_sim(v.x, v.y),
    "cosh": lambda L, S, v: L.cosh(v.x),
    "create_global_var": lambda L, S, v: L.create_global_var([2], 1.0),
    "create_parameter": lambda L, S, v: L.create_parameter([3, 4]),
    "create_tensor": lambda L, S, v: L.create_tensor("float32"),
    "crf_decoding": lambda L, S, v: L.crf_decoding(v.seq, v.lens),
    "crop": lambda L, S, v: L.crop(v.x, [1, 2], [0, 1]),
    "crop_tensor": lambda L, S, v: L.crop_tensor(v.x, [1, 2], [0, 1]),
    "cross_entropy": lambda L, S, v: L.cross_entropy(L.softmax(v.x), v.lab),
    "cross_entropy2": lambda L, S, v: L.cross_entropy2(L.softmax(v.x),
                                                       v.lab),
    "ctc_greedy_decoder": lambda L, S, v: L.ctc_greedy_decoder(
        v.seq, 0, v.lens),
    "cumsum": lambda L, S, v: L.cumsum(v.x, 1, exclusive=True),
    "data": lambda L, S, v: L.data("extra", [7], "float32"),
    "data_norm": lambda L, S, v: L.data_norm(v.x),
    "deformable_conv": lambda L, S, v: L.deformable_conv(
        v.img, L.data("off", [18, 6, 6]), L.data("msk", [9, 6, 6]), 2, 3),
    "density_prior_box": lambda L, S, v: L.density_prior_box(
        v.img, v.img, [2], [4.0]),
    "diag": lambda L, S, v: L.diag(v.x1),
    "dice_loss": lambda L, S, v: L.dice_loss(L.softmax(v.x), v.lab),
    "dropout": lambda L, S, v: L.dropout(v.x, 0.3),
    "dynamic_gru": lambda L, S, v: L.dynamic_gru(L.fc(v.seq, 9, 2), 3,
                                                 v.lens),
    "dynamic_lstm": lambda L, S, v: L.dynamic_lstm(L.fc(v.seq, 12, 2), 12,
                                                   v.lens),
    "edit_distance": lambda L, S, v: L.edit_distance(v.ids3, v.ids3),
    "elu": lambda L, S, v: L.elu(v.x, 0.5),
    "embedding": lambda L, S, v: L.embedding(v.ids3, (10, 4),
                                             padding_idx=0),
    "erf": lambda L, S, v: L.erf(v.x),
    "exp": lambda L, S, v: L.exp(v.x),
    "expand": lambda L, S, v: L.expand(v.x1, [2, 3]),
    "expand_as": lambda L, S, v: L.expand_as(v.x1, v.x),
    "eye": lambda L, S, v: L.eye(3, 4),
    "fc": lambda L, S, v: L.fc(v.x, 5, act="relu"),
    "fill_constant": lambda L, S, v: L.fill_constant([2, 3], "float32",
                                                     1.5),
    "fill_constant_batch_size_like": lambda L, S, v:
        L.fill_constant_batch_size_like(v.x, [-1, 3], "float32", 0.5),
    "fill_zeros_like": lambda L, S, v: L.fill_zeros_like(v.x),
    "filter_by_instag": lambda L, S, v: L.filter_by_instag(v.x, v.ids3,
                                                           v.idx2),
    "flatten": lambda L, S, v: L.flatten(v.img, 2),
    "floor": lambda L, S, v: L.floor(v.x),
    "fsp_matrix": lambda L, S, v: L.fsp_matrix(v.img, v.img4),
    "gather": lambda L, S, v: L.gather(v.x, v.idx2),
    "gather_nd": lambda L, S, v: L.gather_nd(v.w34, L.data(
        "nd", [2, 2], "int32", append_batch_size=False)),
    "gather_tree": lambda L, S, v: L.gather_tree(v.ids3, v.ids3),
    "gaussian_random": lambda L, S, v: L.gaussian_random([2, 3], 1.0, 2.0),
    "gaussian_random_batch_size_like": lambda L, S, v:
        L.gaussian_random_batch_size_like(v.x, [-1, 3]),
    "gelu": lambda L, S, v: L.gelu(v.x),
    "get_tensor_from_selected_rows": lambda L, S, v:
        L.get_tensor_from_selected_rows(v.x),
    "grid_sampler": lambda L, S, v: L.grid_sampler(v.img, v.grid),
    "group_norm": lambda L, S, v: L.group_norm(v.img4, 2),
    "hard_sigmoid": lambda L, S, v: L.hard_sigmoid(v.x),
    "hard_swish": lambda L, S, v: L.hard_swish(v.x),
    "has_inf": lambda L, S, v: L.has_inf(v.x),
    "has_nan": lambda L, S, v: L.has_nan(v.x),
    "huber_loss": lambda L, S, v: L.huber_loss(v.x1, v.y1, 0.5),
    "im2sequence": lambda L, S, v: L.im2sequence(v.img, 2, 2),
    "image_resize": lambda L, S, v: L.image_resize(v.img, [4, 4]),
    "inplace_abn": lambda L, S, v: L.inplace_abn(v.img, "leaky_relu"),
    "instance_norm": lambda L, S, v: L.instance_norm(v.img),
    "iou_similarity": lambda L, S, v: L.iou_similarity(v.boxes, v.boxes),
    "isfinite": lambda L, S, v: L.isfinite(v.x),
    "kldiv_loss": lambda L, S, v: L.kldiv_loss(v.x, v.y, "batchmean"),
    "l2_normalize": lambda L, S, v: L.l2_normalize(v.x, 1),
    "label_smooth": lambda L, S, v: L.label_smooth(v.x, epsilon=0.2),
    "layer_norm": lambda L, S, v: L.layer_norm(v.seq, begin_norm_axis=2),
    "leaky_relu": lambda L, S, v: L.leaky_relu(v.x, 0.1),
    "linear_chain_crf": lambda L, S, v: L.linear_chain_crf(v.seq, v.ids3,
                                                           v.lens),
    "linspace": lambda L, S, v: L.linspace(0.0, 1.0, 5),
    "load_combine": lambda L, S, v: L.load_combine(
        [L.create_tensor(), L.create_tensor()], "params.npz"),
    "lod_append": lambda L, S, v: L.lod_append(v.x, 1),
    "lod_reset": lambda L, S, v: L.lod_reset(v.x, v.y),
    "log": lambda L, S, v: L.log(v.x),
    "log_loss": lambda L, S, v: L.log_loss(L.sigmoid(v.x1), v.y1),
    "log_softmax": lambda L, S, v: L.log_softmax(v.x, 1),
    "logical_and": lambda L, S, v: L.logical_and(v.b1, v.b2),
    "logical_not": lambda L, S, v: L.logical_not(v.b1),
    "logical_or": lambda L, S, v: L.logical_or(v.b1, v.b2),
    "logical_xor": lambda L, S, v: L.logical_xor(v.b1, v.b2),
    "logsigmoid": lambda L, S, v: L.logsigmoid(v.x),
    "lrn": lambda L, S, v: L.lrn(v.img, 3),
    "margin_rank_loss": lambda L, S, v: L.margin_rank_loss(v.y1, v.x1,
                                                           v.y1),
    "matmul": lambda L, S, v: L.matmul(v.x, v.y, transpose_y=True,
                                       alpha=0.5),
    "maxout": lambda L, S, v: L.maxout(v.img4, 2),
    "mean": lambda L, S, v: L.mean(v.x),
    "mean_iou": lambda L, S, v: L.mean_iou(v.ids3, v.ids3, 4),
    "merge_selected_rows": lambda L, S, v: L.merge_selected_rows(v.x),
    "mish": lambda L, S, v: L.mish(v.x),
    "mse_loss": lambda L, S, v: L.mse_loss(v.x, v.y),
    "mul": lambda L, S, v: L.mul(v.x, L.create_parameter([4, 3])),
    "multiclass_nms": lambda L, S, v: L.multiclass_nms(
        L.data("bb", [5, 4]), L.data("sc", [2, 5]), keep_top_k=3),
    "multiplex": lambda L, S, v: L.multiplex([v.x, v.y], v.ids),
    "nce": lambda L, S, v: L.nce(v.x, v.lab, 10, v.ids3),
    "npair_loss": lambda L, S, v: L.npair_loss(v.x, v.y, v.x1),
    "one_hot": lambda L, S, v: L.one_hot(v.ids, 5),
    "ones": lambda L, S, v: L.ones([2, 2]),
    "ones_like": lambda L, S, v: L.ones_like(v.x),
    "pad": lambda L, S, v: L.pad(v.x, [0, 1, 1, 0], 0.5),
    "pad2d": lambda L, S, v: L.pad2d(v.img, (1, 0, 0, 1), "reflect"),
    "pad_constant_like": lambda L, S, v: L.pad_constant_like(v.x, v.x1),
    "pixel_shuffle": lambda L, S, v: L.pixel_shuffle(v.img4, 2),
    "pool2d": lambda L, S, v: L.pool2d(v.img, 2, "avg"),
    "pool3d": lambda L, S, v: L.pool3d(v.vol, 2, "avg"),
    "pow": lambda L, S, v: L.pow(v.x, 2.0),
    "prelu": lambda L, S, v: L.prelu(v.img, "channel"),
    "prior_box": lambda L, S, v: L.prior_box(v.img, v.img, [4.0], [8.0],
                                             (2.0,), flip=True),
    "prroi_pool": lambda L, S, v: L.prroi_pool(v.img, v.rois, 1.0, 2, 2),
    "psroi_pool": lambda L, S, v: L.psroi_pool(v.img4, v.rois, v.ids, 1,
                                               1.0, 2, 2),
    "py_func": lambda L, S, v: L.py_func(_py_identity, v.x,
                                         L.create_tensor()),
    "rank": lambda L, S, v: L.rank(v.img),
    "rank_loss": lambda L, S, v: L.rank_loss(v.y1, v.x1, v.y1),
    "reciprocal": lambda L, S, v: L.reciprocal(v.x),
    "reduce_all": lambda L, S, v: L.reduce_all(v.b1, 1),
    "reduce_any": lambda L, S, v: L.reduce_any(v.b1),
    "reduce_max": lambda L, S, v: L.reduce_max(v.x, 1, True),
    "reduce_mean": lambda L, S, v: L.reduce_mean(v.x, 1),
    "reduce_min": lambda L, S, v: L.reduce_min(v.x, [0, 1]),
    "reduce_prod": lambda L, S, v: L.reduce_prod(v.x, 1),
    "reduce_sum": lambda L, S, v: L.reduce_sum(v.x),
    "relu": lambda L, S, v: L.relu(v.x),
    "relu6": lambda L, S, v: L.relu6(v.x),
    "reshape": lambda L, S, v: L.reshape(v.img, [0, -1]),
    "resize_bilinear": lambda L, S, v: L.resize_bilinear(v.img, [5, 5]),
    "resize_linear": lambda L, S, v: L.resize_linear(v.seq, [8]),
    "resize_nearest": lambda L, S, v: L.resize_nearest(v.img, [16, 16]),
    "resize_trilinear": lambda L, S, v: L.resize_trilinear(v.vol,
                                                           [2, 2, 2]),
    "reverse": lambda L, S, v: L.reverse(v.x, [1]),
    "roi_align": lambda L, S, v: L.roi_align(v.img, v.rois, 2, 2, 0.5, 2),
    "roi_pool": lambda L, S, v: L.roi_pool(v.img, v.rois, 2, 2),
    "round": lambda L, S, v: L.round(v.x),
    "row_conv": lambda L, S, v: L.row_conv(v.seq, 2, v.lens),
    "rsqrt": lambda L, S, v: L.rsqrt(v.x),
    "sampled_softmax_with_cross_entropy": lambda L, S, v:
        L.sampled_softmax_with_cross_entropy(v.x, v.lab, 2),
    "save": lambda L, S, v: L.save(v.x, "x.npy"),
    "save_combine": lambda L, S, v: L.save_combine([v.x, v.y], "xy.npz"),
    "scale": lambda L, S, v: L.scale(v.x, 2.0, 1.0, False),
    "scatter": lambda L, S, v: L.scatter(v.x, v.idx2, v.x, False),
    "scatter_nd": lambda L, S, v: L.scatter_nd(
        L.data("snd", [2, 1], "int32", append_batch_size=False),
        L.data("upd", [2, 4], append_batch_size=False), [5, 4]),
    "scatter_nd_add": lambda L, S, v: L.scatter_nd_add(v.w34, L.data(
        "sna", [2, 1], "int32", append_batch_size=False),
        L.data("upa", [2, 4], append_batch_size=False)),
    "selu": lambda L, S, v: L.selu(v.x),
    "sequence_conv": lambda L, S, v: L.sequence_conv(v.seq, 3, 3,
                                                     sequence_length=v.lens),
    "sequence_first_step": lambda L, S, v: L.sequence_first_step(v.seq,
                                                                 v.lens),
    "sequence_last_step": lambda L, S, v: L.sequence_last_step(v.seq,
                                                               v.lens),
    "sequence_mask": lambda L, S, v: L.sequence_mask(v.lens, 5),
    "sequence_pool": lambda L, S, v: L.sequence_pool(v.seq, "max", v.lens),
    "sequence_reverse": lambda L, S, v: L.sequence_reverse(v.seq, v.lens),
    "sequence_softmax": lambda L, S, v: L.sequence_softmax(
        L.reshape(v.seq, [-1, 20]), v.lens),
    "shape": lambda L, S, v: L.shape(v.img),
    "shard_index": lambda L, S, v: L.shard_index(v.ids, 20, 2, 1),
    "shuffle_channel": lambda L, S, v: L.shuffle_channel(v.img4, 2),
    "sigmoid": lambda L, S, v: L.sigmoid(v.x),
    "sigmoid_cross_entropy_with_logits": lambda L, S, v:
        L.sigmoid_cross_entropy_with_logits(v.x, v.y, normalize=True),
    "sigmoid_focal_loss": lambda L, S, v: L.sigmoid_focal_loss(
        v.x, v.lab, v.ids),
    "sign": lambda L, S, v: L.sign(v.x),
    "silu": lambda L, S, v: L.silu(v.x),
    "sin": lambda L, S, v: L.sin(v.x),
    "sinh": lambda L, S, v: L.sinh(v.x),
    "size": lambda L, S, v: L.size(v.x),
    "slice": lambda L, S, v: L.slice(v.x, [1], [1], [3]),
    "smooth_l1": lambda L, S, v: L.smooth_l1(v.x, v.y, 2.0),
    "soft_relu": lambda L, S, v: L.soft_relu(v.x),
    "softmax": lambda L, S, v: L.softmax(v.x, 1),
    "softmax_with_cross_entropy": lambda L, S, v:
        L.softmax_with_cross_entropy(v.x, v.lab, return_softmax=True),
    "softplus": lambda L, S, v: L.softplus(v.x),
    "softsign": lambda L, S, v: L.softsign(v.x),
    "space_to_depth": lambda L, S, v: L.space_to_depth(v.img, 2),
    "spectral_norm": lambda L, S, v: L.spectral_norm(
        L.create_parameter([4, 6]), power_iters=2),
    "split": lambda L, S, v: L.split(v.x, [1, 3], 1),
    "sqrt": lambda L, S, v: L.sqrt(v.x),
    "square": lambda L, S, v: L.square(v.x),
    "square_error_cost": lambda L, S, v: L.square_error_cost(v.x, v.y),
    "squeeze": lambda L, S, v: L.squeeze(v.x1, [1]),
    "stack": lambda L, S, v: L.stack([v.x, v.y], 1),
    "stanh": lambda L, S, v: L.stanh(v.x),
    "strided_slice": lambda L, S, v: L.strided_slice(v.x, [1], [0], [4],
                                                     [2]),
    "sum": lambda L, S, v: L.sum([v.x, v.y]),
    "sums": lambda L, S, v: L.sums([v.x, v.y]),
    "swish": lambda L, S, v: L.swish(v.x),
    "tan": lambda L, S, v: L.tan(v.x),
    "tanh": lambda L, S, v: L.tanh(v.x),
    "teacher_student_sigmoid_loss": lambda L, S, v:
        L.teacher_student_sigmoid_loss(v.x1, v.y1),
    "temporal_shift": lambda L, S, v: L.temporal_shift(v.img4, 2),
    "tile": lambda L, S, v: L.tile(v.x, [1, 2]),
    "topk": lambda L, S, v: L.topk(v.x, 2),
    "transpose": lambda L, S, v: L.transpose(v.img, [0, 2, 3, 1]),
    "unbind": lambda L, S, v: L.unbind(v.w34, 0),
    "unfold": lambda L, S, v: L.unfold(v.img, [2, 2], 2),
    "uniform_random": lambda L, S, v: L.uniform_random([2, 3], min=-2.0),
    "uniform_random_batch_size_like": lambda L, S, v:
        L.uniform_random_batch_size_like(v.x, [-1, 2]),
    "unsqueeze": lambda L, S, v: L.unsqueeze(v.x, [1]),
    "unstack": lambda L, S, v: L.unstack(v.w34, 0),
    "warpctc": lambda L, S, v: L.warpctc(v.tmaj, v.ids3,
                                         input_length=v.lens,
                                         label_length=v.lens),
    "where": lambda L, S, v: L.where(v.b1, v.x, v.y),
    "yolo_box": lambda L, S, v: L.yolo_box(
        L.data("yx", [14, 4, 4]), L.data("ys", [2], "int32"),
        [10, 13, 16, 30], 2),
    "yolov3_loss": lambda L, S, v: L.yolov3_loss(
        L.data("lx", [14, 4, 4]), L.data("gb", [2, 4]),
        L.data("gl", [2], "int32"), [10, 13, 16, 30], [0, 1], 2, 0.7, 8),
    "zeros": lambda L, S, v: L.zeros([2, 2], "int32"),
    "zeros_like": lambda L, S, v: L.zeros_like(v.x),
}
for _n in ("elementwise_add", "elementwise_div", "elementwise_floordiv",
           "elementwise_max", "elementwise_min", "elementwise_mod",
           "elementwise_mul", "elementwise_pow", "elementwise_sub"):
    CALLS[_n] = (lambda n: lambda L, S, v: getattr(L, n)(v.img, v.x1,
                                                         axis=1))(_n)

# the framework's and the standard library's names the module re-exports
REEXPORTS = ("I", "Optional", "Sequence", "annotations", "math", "np",
             "Parameter", "Program", "Variable", "default_main_program",
             "default_startup_program", "unique_name")


def _public(L):
    return sorted(n for n in dir(L) if not n.startswith("_"))


def test_the_port_has_every_public_name():
    import paddle_tpu.static.layers as JL
    import paddle_tpu_torch.static.layers as TL

    assert len(_public(JL)) == 241
    assert _public(TL) == _public(JL)
    assert set(_public(JL)) == set(CALLS) | set(REEXPORTS)


def test_the_static_namespace_lacks_only_the_later_items():
    """``paddle_tpu_torch.static`` has every name of ``paddle_tpu.static``
    but those of item 9b, and every module file but item 9b's
    ``compiler`` and item 9c-ii's ``compile_cache``.  A submodule is an
    attribute of its package once something imports it, so submodules are
    checked by the port's module files, not by ``dir``."""
    import importlib.util
    import types

    later = {"BuildStrategy", "ExecutionStrategy", "CompiledProgram"}
    later_modules = {"compiler", "compile_cache"}
    jax = {n for n in dir(jstatic) if not n.startswith("_")}
    port = {n for n in dir(tstatic) if not n.startswith("_")}
    modules = {n for n in jax if isinstance(getattr(jstatic, n),
                                            types.ModuleType)}
    assert (jax - modules) - port == later
    no_file = {n for n in modules if importlib.util.find_spec(
        f"paddle_tpu_torch.static.{n}") is None}
    assert no_file <= later_modules
    assert {"cond", "while_loop", "StaticRNN", "save", "load",
            "save_inference_model", "load_inference_model",
            "save_persistables", "load_persistables", "equal",
            "logical_xor", "increment"} <= port


def _build(S, name):
    main, start = S.Program(), S.Program()
    with S.program_guard(main, start):
        v = _Vars(S.layers)
        CALLS[name](S.layers, S, v)
    return main, start


@pytest.mark.parametrize("name", sorted(CALLS))
def test_builder_appends_the_same_ops(name):
    jmain, jstart = _build(jstatic, name)
    tmain, tstart = _build(tstatic, name)
    assert _canon_prog(tmain) == _canon_prog(jmain)
    assert _canon_prog(tstart) == _canon_prog(jstart)
    assert [tuple(v.shape) for v in tmain.list_vars()] == \
        [tuple(v.shape) for v in jmain.list_vars()]
