"""Static model I/O in the port against the JAX package: the port's own
round trips (persistables, ``save`` / ``load``, inference models; fp32,
bf16 and int32 parameters keep their dtypes), native inference models
saved by either package loading in the other with equal fetches, the
reference's ``__model__`` format written by ``proto_format`` loading in
both, ``cipher=`` round trips across packages, and
``PostTrainingQuantization(model_prefix=...)`` against the JAX route."""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.static as jstatic
import paddle_tpu_torch.static as tstatic
from paddle_tpu.slim import quant_static as jqs
from paddle_tpu.utils import crypto as jcrypto
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import native as tnative
from paddle_tpu_torch.slim import quant_static as tqs
from paddle_tpu_torch.static import io as tio
from paddle_tpu_torch.utils import crypto as tcrypto

JAX, TORCH = jstatic, tstatic
REL = 1e-5


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _exe(S):
    return S.Executor() if S is JAX else S.Executor("cpu")


def _net(S):
    L = S.layers
    main, start = S.Program(), S.Program()
    with S.program_guard(main, start):
        img = L.data("img", [2, 8, 8], "float32")
        c = L.conv2d(img, 4, 3, padding=1)
        b = L.batch_norm(c, act="relu", is_test=True)
        p = L.pool2d(b, 2, "max")
        out = L.fc(L.dropout(p, 0.5, is_test=True), 3, act="softmax")
    return main, start, out


def _pair():
    jmain, jstart, jout = _net(JAX)
    tmain, _, tout = _net(TORCH)
    jscope = JAX.Scope()
    JAX.Executor().run(jstart, scope=jscope)
    state = {k: np.asarray(jscope.find_var(k)) for k in jscope.keys()}
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    return (jmain, jout, jscope), (tmain, tout, tscope)


FEED = {"img": np.random.default_rng(0).normal(0, 1, (3, 2, 8, 8))
        .astype(np.float32)}


def _save(S, prog, out, scope, d, **kw):
    S.save_inference_model(d, ["img"], [out], _exe(S), main_program=prog,
                           scope=scope, **kw)


def _load_run(S, d, **kw):
    scope = S.Scope()
    exe = _exe(S)
    prog, feeds, fetches = S.load_inference_model(d, exe, scope=scope, **kw)
    assert feeds == ["img"]
    got, = exe.run(prog, feed=FEED, fetch_list=fetches, scope=scope)
    return got


@pytest.mark.parametrize("fmt", ["native", "__model__"])
def test_an_inference_model_saved_by_either_package_loads_in_both(tmp_path,
                                                                  fmt):
    (jmain, jout, jscope), (tmain, tout, tscope) = _pair()
    ref, = JAX.Executor().run(jmain, feed=FEED, fetch_list=[jout],
                              scope=jscope)
    kw = {} if fmt == "native" else {"model_filename": "__model__"}
    _save(JAX, jmain, jout, jscope, str(tmp_path / "j"), **kw)
    _save(TORCH, tmain, tout, tscope, str(tmp_path / "t"), **kw)
    for saver in ("j", "t"):
        for S in (JAX, TORCH):
            got = _load_run(S, str(tmp_path / saver))
            assert _rel(got, ref) <= REL, (saver, S.__name__)
    if fmt == "native":
        # the same files: program.json op for op, params.npz array for array
        jp = json.load(open(tmp_path / "j" / "program.json"))
        tp = json.load(open(tmp_path / "t" / "program.json"))
        assert [o["type"] for o in tp["program"]["ops"]] == \
            [o["type"] for o in jp["program"]["ops"]]
        assert tp["program"]["op_versions"] == jp["program"]["op_versions"]
        jz = np.load(tmp_path / "j" / "params.npz")
        tz = np.load(tmp_path / "t" / "params.npz")
        assert sorted(a.shape for a in (jz[k] for k in jz.files)) == \
            sorted(a.shape for a in (tz[k] for k in tz.files))
    else:
        assert os.path.exists(tmp_path / "t" / "__model__")


def test_persistables_and_save_load_round_trip_dtypes(tmp_path):
    (_, _, _), (tmain, tout, tscope) = _pair()
    w = "bf16_state"
    tscope.set(w, torch.tensor([1.5, -2.0, 3.0e-3], dtype=torch.bfloat16))
    tscope.set("step_counter", torch.tensor([7], dtype=torch.int32))
    blk = tmain.global_block()
    blk.create_var(name=w, shape=(3,), dtype="bfloat16", persistable=True)
    blk.create_var(name="step_counter", shape=(1,), dtype="int32",
                   persistable=True)
    tstatic.save_persistables(_exe(TORCH), str(tmp_path / "p"), tmain,
                              scope=tscope)
    tstatic.save(tmain, str(tmp_path / "m" / "model"), scope=tscope,
                 fetches=[tout])
    for load in ("persistables", "prefix"):
        scope = TORCH.Scope()
        if load == "persistables":
            tstatic.load_persistables(_exe(TORCH), str(tmp_path / "p"),
                                      tmain, scope=scope)
            prog = tmain
        else:
            prog, feeds, fetches = tstatic.load(
                str(tmp_path / "m" / "model"), scope=scope)
            assert "img" in feeds and fetches == [tout.name]
        bf = torch.as_tensor(scope.find_var(w))
        assert bf.dtype == torch.bfloat16
        assert torch.equal(bf, torch.as_tensor(tscope.find_var(w)))
        step = np.asarray(scope.find_var("step_counter"))
        assert step.dtype == np.int32 and step.tolist() == [7]
        got, = TORCH.Executor("cpu").run(prog, feed=FEED, fetch_list=[tout],
                                         scope=scope)
        ref, = TORCH.Executor("cpu").run(tmain, feed=FEED,
                                         fetch_list=[tout], scope=tscope)
        np.testing.assert_array_equal(got, ref)


def test_bf16_parameters_are_stored_as_the_jax_package_stores_them(tmp_path):
    t = torch.tensor([1.0, -2.5, 3.0e-3], dtype=torch.bfloat16)
    saved = tio._to_saved(t)
    assert saved.dtype.kind == "V" and saved.dtype.itemsize == 2
    import jax.numpy as jnp

    ref = np.asarray(jnp.asarray([1.0, -2.5, 3.0e-3], jnp.bfloat16))
    assert saved.tobytes() == ref.tobytes()
    np.savez(tmp_path / "w.npz", w=saved)
    back = tio._from_saved(np.load(tmp_path / "w.npz")["w"])
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


@pytest.mark.skipif(not tnative.available(),
                    reason="the native runtime does not build here")
def test_cipher_round_trips_across_packages(tmp_path):
    (jmain, jout, jscope), (tmain, tout, tscope) = _pair()
    key = tcrypto.generate_key(32)
    tc, jc = tcrypto.Cipher(key), jcrypto.Cipher(key)
    ref, = JAX.Executor().run(jmain, feed=FEED, fetch_list=[jout],
                              scope=jscope)
    _save(TORCH, tmain, tout, tscope, str(tmp_path / "t"), cipher=tc)
    _save(JAX, jmain, jout, jscope, str(tmp_path / "j"), cipher=jc)
    assert not os.path.exists(tmp_path / "t" / "params.npz")
    for saver in ("t", "j"):
        assert _rel(_load_run(TORCH, str(tmp_path / saver), cipher=tc),
                    ref) <= REL
        assert _rel(_load_run(JAX, str(tmp_path / saver), cipher=jc),
                    ref) <= REL
        with pytest.raises(ValueError, match="cipher"):
            TORCH.load_inference_model(str(tmp_path / saver),
                                       _exe(TORCH), scope=TORCH.Scope())
    blob = tc.encrypt(b"payload")
    assert jc.decrypt(blob) == b"payload"


def test_ptq_model_prefix_matches_the_jax_route(tmp_path):
    (jmain, jout, jscope), (tmain, tout, tscope) = _pair()
    JAX.save(jmain, str(tmp_path / "j" / "m"), scope=jscope, fetches=[jout])
    TORCH.save(tmain, str(tmp_path / "t" / "m"), scope=tscope,
               fetches=[tout])
    calib = lambda: iter([FEED])  # noqa: E731
    outs = {}
    for S, qs, d, out_name in ((JAX, jqs, "j", jout.name),
                               (TORCH, tqs, "t", tout.name)):
        scope = S.Scope()
        with S.scope_guard(scope):   # the JAX route calibrates in it
            ptq = qs.PostTrainingQuantization(
                _exe(S), model_prefix=str(tmp_path / d / "m"),
                batch_generator=calib, batch_nums=1, scope=scope)
            assert ptq.feed_names == ["img"]
            prog = ptq.quantize()
            ptq.save_quantized_model(str(tmp_path / d / "q"))
        # save_quantized_model names no fetches, in both packages
        qscope = S.Scope()
        qprog, _, fetches = S.load(str(tmp_path / d / "q"), scope=qscope)
        assert fetches == []
        outs[d] = (_exe(S).run(prog, feed=FEED, fetch_list=[out_name],
                               scope=scope)[0],
                   _exe(S).run(qprog, feed=FEED, fetch_list=[out_name],
                               scope=qscope)[0],
                   [op.type for op in qprog.global_block().ops])
    (jq, jl, jops), (tq, tl, tops) = outs["j"], outs["t"]
    assert tops == jops and "fake_quantize_dequantize_fixed_scale" in tops
    np.testing.assert_array_equal(tl, tq)
    assert _rel(tq, jq) <= 1e-4


def _lstm_program(S):
    L = S.layers
    main, start = S.Program(), S.Program()
    with S.program_guard(main, start):
        x = L.data("x", [5, 8], "float32")
        n = L.data("n", [], "int64")
        h, _ = L.dynamic_lstm(x, 8, sequence_length=n)
    return main, start, h


def test_a_control_flow_program_keeps_its_sub_blocks(tmp_path):
    """The port's clone and save_inference_model keep a program's
    sub-blocks (here dynamic_lstm's StaticRNN step): the reloaded model
    gives the in-memory fetch.  The JAX package's clone keeps block 0 only,
    and its save_inference_model cannot write the program (the
    sequence_mask attr holds a jnp dtype, not a JSON value): ROADMAP
    Queue 3."""
    main, start, h = _lstm_program(TORCH)
    assert len(main.blocks) == 2 and len(main.clone().blocks) == 2
    exe, scope = _exe(TORCH), TORCH.Scope()
    exe.run(start, scope=scope)
    rng = np.random.default_rng(4)
    feed = {"x": rng.normal(0, 1, (3, 5, 8)).astype(np.float32),
            "n": np.asarray([5, 2, 4], np.int64)}
    ref, = exe.run(main, feed=feed, fetch_list=[h], scope=scope)
    d = str(tmp_path / "lstm")
    TORCH.save_inference_model(d, ["x", "n"], [h], exe, main_program=main,
                               scope=scope)
    scope2 = TORCH.Scope()
    prog, feeds, fetches = TORCH.load_inference_model(d, exe, scope=scope2)
    assert len(prog.blocks) == 2
    got, = exe.run(prog, feed=feed, fetch_list=fetches, scope=scope2)
    np.testing.assert_array_equal(got, ref)
    # the reference faults this repairs
    jmain, jstart, jh = _lstm_program(JAX)
    assert len(jmain.blocks) == 2 and len(jmain.clone().blocks) == 1
    jexe, jscope = JAX.Executor(), JAX.Scope()
    jexe.run(jstart, scope=jscope)
    with pytest.raises(TypeError, match="JSON serializable"):
        JAX.save_inference_model(str(tmp_path / "j"), ["x", "n"], [jh], jexe,
                                 main_program=jmain, scope=jscope)


def test_bf16_params_saved_by_the_jax_package_load_as_void(tmp_path):
    """A bf16 parameter in the JAX package's params.npz is numpy's raw V2;
    the JAX loader hands that void array to its scope unchanged (ROADMAP
    Queue 3), the port's reads it back as bfloat16."""
    import jax.numpy as jnp

    w = np.asarray(jnp.asarray([[1.0, -0.5]], jnp.bfloat16))
    np.savez(tmp_path / "params.npz", w=w)
    raw = np.load(tmp_path / "params.npz")["w"]
    assert raw.dtype.kind == "V"
    back = tio._from_saved(raw)
    assert back.dtype == torch.bfloat16
    assert back.float().tolist() == [[1.0, -0.5]]


def test_ptq_calibrates_in_the_scope_it_is_given(tmp_path):
    """The JAX PTQ's calibration runs in the global scope, not the
    ``scope=`` it was given (``paddle_tpu/slim/quant_static.py:257``):
    loaded from a prefix into another scope it finds no parameters there
    (ROADMAP Queue 3).  The port's calibrates in its scope."""
    from paddle_tpu.core import errors as jerrors

    (jmain, jout, jscope), (tmain, tout, tscope) = _pair()
    JAX.save(jmain, str(tmp_path / "j" / "m"), scope=jscope)
    TORCH.save(tmain, str(tmp_path / "t" / "m"), scope=tscope)
    calib = lambda: iter([FEED])  # noqa: E731
    jptq = jqs.PostTrainingQuantization(
        JAX.Executor(), model_prefix=str(tmp_path / "j" / "m"),
        batch_generator=calib, batch_nums=1, scope=JAX.Scope())
    with pytest.raises(jerrors.PreconditionNotMetError, match="no value"):
        jptq.quantize()
    tptq = tqs.PostTrainingQuantization(
        _exe(TORCH), model_prefix=str(tmp_path / "t" / "m"),
        batch_generator=calib, batch_nums=1, scope=TORCH.Scope())
    ops = [op.type for op in tptq.quantize().global_block().ops]
    assert "fake_quantize_dequantize_fixed_scale" in ops
