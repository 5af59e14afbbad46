"""Machine-checked registry coverage vs the reference's operator macros.

``tests/test_registry_exhaustive.py`` greps every ``REGISTER_OPERATOR`` /
``REGISTER_OP_WITHOUT_GRADIENT`` in ``/root/reference/paddle/fluid`` (non-
test files) and asserts that every base op name is either (a) a registered
lowering, or (b) listed HERE with a rationale.  README.md's "the rest,
exhaustively" claim points at this table — adding a reference op without a
lowering or an entry breaks the suite, so the claim cannot silently rot.

Rationale categories:
- ``executor``: realized by the Executor/jit runtime itself, not a per-op
  lowering (control flow, feed/fetch, readers).
- ``engine``: subgraph/fusion engines that XLA replaces wholesale.
- ``service``: RPC/pslib/BoxPS control- or data-plane clients of services
  that live OUTSIDE jitted programs here (distributed/ps_server.py is the
  capability re-scope; VERDICT r03/r04 accepted the descope).
- ``host``: ops whose contract is inherently host-side/dynamic in a way
  the static TPU path re-scopes elsewhere (named alternative given).
"""
from __future__ import annotations

DESCOPED = {
    # -- executor-realized (not per-op lowerings) -------------------------
    "conditional_block": "executor: cond builders lower straight to "
                         "lax.cond (executor._lower_cond); the block-op "
                         "encoding never materializes",
    "conditional_block_infer": "executor: same as conditional_block (the "
                               "infer variant skips scope retention, which "
                               "the functional lowering never needed)",
    "while": "executor: _lower_while emits lax.while_loop",
    "recurrent": "executor: StaticRNN collapses to lax.scan "
                 "(_lower_static_rnn); the block-op encoding is internal",
    "feed": "executor: feeds bind via the env dict (executor.py run())",
    "fetch": "executor: fetch_list reads from the env dict",
    "read": "executor: DataLoader feeds arrays; no reader op graph node",
    "create_custom_reader": "executor: reader decorators collapse into the "
                            "python DataLoader pipeline (io/)",
    "enqueue": "executor: queue runtime belongs to DataLoader workers",
    "dequeue": "executor: same",
    "queue_generator": "executor: same",
    "get_places": "executor: device enumeration is core.device.Place / "
                  "jax.devices(), never a graph op",
    "delete_var": "executor: GC is XLA buffer lifetime + env dict scoping",
    "dummy": "executor: placeholder op with no semantics",
    "rnn_memory_helper": "executor: dygraph-era RNN memory plumbing; "
                         "lax.scan carries state explicitly",
    "lod_rank_table": "executor: LoD rank tables order variable-length "
                      "sequences for DynamicRNN; the dense (B, T)+Length "
                      "layout (core/lod.py) sorts with argsort instead",
    "reorder_lod_tensor_by_rank": "executor: same rank-table machinery",
    "max_sequence_len": "executor: lengths.max() on the explicit Length "
                        "vector (dense sequence contract)",
    "lod_array_length": "executor: tensor-array length is len() of the "
                        "env's python list (ops_tail2 tensor-array note)",
    "tensor_array_to_tensor": "executor: jnp.stack/concat of the env "
                              "list; write_to_array/read_from_array are "
                              "registered, the pack step is jnp",
    "fill_zeros_like2": None,  # registered in ops_tail5
    # -- engines / fused kernels XLA owns --------------------------------
    "tensorrt_engine": "engine: XLA is the engine",
    "lite_engine": "engine: XLA is the engine",
    "fusion_group": "engine: NVRTC runtime codegen; XLA fusion replaces it",
    "conv2d_fusion": "engine: cuDNN fused conv+bias+act; XLA fuses the "
                     "same epilogue automatically",
    "conv2d_inception_fusion": "engine: same (cuDNN-specific)",
    "multihead_matmul": "engine: TRT-era fused attention; the Pallas "
                        "flash kernels are the TPU counterpart",
    "fused_batch_norm_act": "engine: XLA fuses BN+act epilogues; the "
                            "r05 vision ladder measures this fusion",
    "fused_elemwise_activation": "engine: generic elementwise fusion is "
                                 "XLA's bread and butter",
    "fused_embedding_eltwise_layernorm": "engine: TRT fused kernel; "
                                         "XLA + Pallas LN cover it",
    "fused_fc_elementwise_layernorm": "engine: same",
    "fused_embedding_seq_pool": "engine: lookup+pool fuses under jit "
                                "(embedding + sequence_pool lowerings)",
    "fusion_seqpool_cvm_concat": "engine: fusion_seqpool_concat + cvm "
                                 "lowerings fuse under jit",
    "fusion_transpose_flatten_concat": "engine: transpose+reshape+concat "
                                       "is a pure-layout chain XLA folds",
    "nccl": "engine: NCCL init/comm ops; ICI collectives are built into "
            "the mesh runtime (parallel/)",
    # -- RPC / pslib / BoxPS service clients ------------------------------
    "listen_and_serv": "service: the PS serve loop is "
                       "distributed/ps_server.py (PSServer), a process, "
                       "not a graph op",
    "fl_listen_and_serv": "service: federated-learning variant of the "
                          "same serve loop",
    "send": "service: transport lives in ps_server._Conn",
    "recv": "service: same",
    "send_barrier": "service: PSServer barrier op (_OP_BARRIER)",
    "fetch_barrier": "service: same",
    "send_and_recv": "service: same transport",
    "recv_save": "service: server-side checkpoint of remote vars; "
                 "SparseTable.state_dict + utils/fs cover the capability",
    "checkpoint_notify": "service: same",
    "prefetch": "service: sparse-table prefetch RPC; RemoteSparseTable "
                "pulls synchronously (documented N23 descope)",
    "ref_by_trainer_id": "service: PS-side per-trainer slicing",
    "pull_box_sparse": "service: BoxPS (Baidu KV service) client; "
                       "host-RAM SparseTable is the re-scope",
    "pull_box_extended_sparse": "service: same",
    "push_box_sparse": "service: same",
    "push_box_extended_sparse": "service: same",
    "push_dense": "service: pslib dense push; fleet dp allreduce covers it",
    "lookup_sparse_table_init": "service: pslib large-scale-KV init; "
                                "SparseTable ctor is the re-scope",
    "lookup_sparse_table_read": "service: SparseTable.pull",
    "lookup_sparse_table_write": "service: SparseTable.push",
    "lookup_sparse_table_grad_split": "service: GeoCommunicator delta "
                                      "splitting covers the capability",
    "lookup_table_dequant": "service: quantized pslib table read; "
                            "slim/ dequant ops + SparseTable cover the "
                            "pieces",
    # -- host-side / contrib re-scopes ------------------------------------
    "run_program": "host: dygraph partial-program op; jit/dy2static.py "
                   "converts at the AST level instead",
    "rank_attention": "host: contrib op marked 'not shown to the public' "
                      "in its own AddComment",
    "similarity_focus": "host: contrib attention-visualization op with "
                        "serial per-channel dedup semantics; no model in "
                        "the reference zoo consumes it",
    "tdm_child": None,  # registered in ops_tail7
    "tdm_sampler": None,  # registered in ops_tail7
    "match_matrix_tensor": None,  # registered in ops_tail7
    "sequence_topk_avg_pooling": None,  # registered in ops_tail7
    "var_conv_2d": None,  # registered in ops_tail3
    # -- detection label-generation (RCNN/RetinaNet training pipelines) ---
    "generate_proposals": None,  # registered in ops_tail6
    "generate_proposal_labels": None,  # registered in ops_tail7
    "generate_mask_labels": "host: Mask R-CNN mask-target generation "
                            "rasterizes per-instance POLYGON annotations "
                            "(Poly2Mask, variable vertex counts per gt) "
                            "into roi-cropped grids — the polygon inputs "
                            "are inherently ragged host data, unlike the "
                            "box-only sampling of the now-registered "
                            "generate_proposal_labels",
    "rpn_target_assign": None,    # registered in ops_tail6
    "retinanet_target_assign": None,  # registered in ops_tail7
    "retinanet_detection_output": None,  # registered in ops_tail7
    "distribute_fpn_proposals": None,  # registered in ops_tail6
    "collect_fpn_proposals": None,     # registered in ops_tail6
    "box_decoder_and_assign": None,  # registered in ops_tail6
    "deformable_psroi_pooling": None,  # registered in ops_tail7
    "locality_aware_nms": "host: OCR-specific NMS variant of the "
                          "registered multiclass_nms",
    "matrix_nms": None,           # registered in ops_tail6
    "roi_perspective_transform": None,  # registered in ops_tail7
    "mine_hard_examples": None,   # registered in ops_tail5
    "detection_map": "host: mAP metric with per-class ragged accumulation; "
                     "metric/metrics.py DetectionMAP is the eager "
                     "re-scope",
    "bipartite_match": None,      # registered in ops_tail5
    "target_assign": None,        # registered in ops_tail5
    "polygon_box_transform": None,  # registered in ops_tail5
    # -- misc ------------------------------------------------------------
    "hierarchical_sigmoid": None,  # registered in ops_tail5
    "cross_entropy_grad2": "executor: paired grad kernel; gradients come "
                           "from AD-of-replay",
}

# prune the None markers (ops that WERE registered after the table was
# first written — kept as comments for audit history)
DESCOPED = {k: v for k, v in DESCOPED.items() if v is not None}
