"""The Paddle book programs of tests/test_book*.py, built with each
package's DSL at those tests' sizes: fit_a_line, word2vec, image
classification (ResNet), understand_sentiment (conv and dynamic_lstm),
label semantic roles (db_lstm + linear_chain_crf) and machine translation
(the StaticRNN train decoder and the while_loop greedy decode).  The JAX
startup state is carried into the port by ``convert.static_state_from_jax``;
the losses of 3 training steps agree within 5e-4 relative, and the
inference fetches (a saved-and-reloaded model, a CRF decode, the greedy
decode's ids) agree with the JAX Executor's."""
import numpy as np
import pytest

import paddle_tpu.static as jstatic
import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch import convert

JAX, TORCH = jstatic, tstatic
LOSS_REL = 5e-4
FETCH_REL = 1e-4


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _both(build):
    """Build in both packages; returns [(S, main, fetches, exe, scope)]
    with the JAX startup state carried into the port."""
    out = []
    for S in (JAX, TORCH):
        main, start = S.Program(), S.Program()
        with S.program_guard(main, start):
            fetches = build(S, S.layers)
        out.append([S, main, start, fetches])
    (_, jmain, jstart, _), (_, tmain, _, _) = out
    jscope = JAX.Scope()
    JAX.Executor().run(jstart, scope=jscope)
    state = {k: np.asarray(jscope.find_var(k)) for k in jscope.keys()}
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    out[0] += [JAX.Executor(), jscope]
    out[1] += [TORCH.Executor("cpu"), tscope]
    return out


def _train_both(pair, batches, loss_idx=0):
    """Run the batches through both; the fetches of every step."""
    runs = []
    for S, main, _, fetches, exe, scope in pair:
        runs.append([exe.run(main, feed=b, fetch_list=fetches, scope=scope)
                     for b in batches])
    jruns, truns = runs
    for step, (j, t) in enumerate(zip(jruns, truns)):
        assert _rel(t[loss_idx], j[loss_idx]) <= LOSS_REL, (step,
                                                            t[loss_idx],
                                                            j[loss_idx])
    return jruns, truns


def _reload_both(pair, tmp_path, feed_names, target_idx, probe):
    """save_inference_model in each package, load each in the other too:
    every (saver, loader) pair gives the saver's in-memory fetch (``probe``
    feeds the whole training program; the reloaded one takes its feeds)."""
    dirs, ref = {}, {}
    for S, main, _, fetches, exe, scope in pair:
        d = str(tmp_path / S.__name__.split(".")[0])
        S.save_inference_model(d, feed_names, [fetches[target_idx]], exe,
                               main_program=main, scope=scope)
        dirs[S] = d
        ref[S], = exe.run(main, feed=probe, fetch_list=[fetches[target_idx]],
                          scope=scope)
    assert _rel(ref[TORCH], ref[JAX]) <= FETCH_REL
    for saver in (JAX, TORCH):
        for loader in (JAX, TORCH):
            exe = loader.Executor() if loader is JAX \
                else loader.Executor("cpu")
            scope = loader.Scope()
            prog, feeds, fetch = loader.load_inference_model(
                dirs[saver], exe, scope=scope)
            assert feeds == list(feed_names)
            got, = exe.run(prog, feed={k: probe[k] for k in feeds},
                           fetch_list=fetch, scope=scope)
            assert _rel(got, ref[saver]) <= FETCH_REL, (saver, loader)


# -- fit_a_line / word2vec (tests/test_book.py) -------------------------------

def _fit_a_line(S, L):
    x = L.data("x", [13])
    y_predict = L.fc(x, 1, act=None)
    y = L.data("y", [1])
    avg_cost = L.mean(L.square_error_cost(y_predict, y))
    S.optimizer.SGD(learning_rate=0.01).minimize(avg_cost)
    return [avg_cost, y_predict]


def test_fit_a_line(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(0, 1, (60, 13)).astype(np.float32)
    Y = (X @ rng.normal(0, 1, (13, 1))).astype(np.float32)
    pair = _both(_fit_a_line)
    _train_both(pair, [{"x": X[i:i + 20], "y": Y[i:i + 20]}
                       for i in range(0, 60, 20)])
    _reload_both(pair, tmp_path, ["x"], 1, {"x": X[:8], "y": Y[:8]})


def _word2vec(S, L, dict_size=64):
    words = [L.data(n, [1], dtype="int64")
             for n in ("firstw", "secondw", "thirdw", "forthw")]
    next_word = L.data("nextw", [1], dtype="int64")
    embeds = [L.embedding(w, size=[dict_size, 32], param_attr="shared_w")
              for w in words]
    concat = L.concat([L.reshape(e, [-1, 32]) for e in embeds], axis=1)
    hidden = L.fc(concat, 256, act="sigmoid")
    predict = L.fc(hidden, dict_size, act="softmax")
    avg_cost = L.mean(L.cross_entropy(predict, next_word))
    S.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return [avg_cost, predict]


def _w2v_feed(words, nxt, i, b=32):
    names = ("firstw", "secondw", "thirdw", "forthw")
    feed = {n: words[i:i + b, k:k + 1] for k, n in enumerate(names)}
    feed["nextw"] = nxt[i:i + b, None]
    return feed


def test_word2vec(tmp_path):
    rng = np.random.default_rng(1)
    words = rng.integers(0, 64, (96, 4)).astype(np.int64)
    nxt = (words.sum(axis=1) % 64).astype(np.int64)
    pair = _both(_word2vec)
    _train_both(pair, [_w2v_feed(words, nxt, i) for i in range(0, 96, 32)])
    probe = _w2v_feed(words, nxt, 0, 4)
    _reload_both(pair, tmp_path, ["firstw", "secondw", "thirdw", "forthw"],
                 1, probe)


# -- image classification / understand_sentiment -----------------------------

def _conv_bn(L, input, ch_out, k, stride, padding, act="relu",
             bias_attr=False):
    tmp = L.conv2d(input, ch_out, k, stride=stride, padding=padding,
                   act=None, bias_attr=bias_attr)
    return L.batch_norm(tmp, act=act)


def _resnet(S, L, depth=8):
    def block(input, ch_in, ch_out, stride):
        tmp = _conv_bn(L, input, ch_out, 3, stride, 1)
        tmp = _conv_bn(L, tmp, ch_out, 3, 1, 1, act=None, bias_attr=None)
        short = (_conv_bn(L, input, ch_out, 1, stride, 0, None)
                 if ch_in != ch_out else input)
        return L.elementwise_add(tmp, short, act="relu")

    images = L.data("pixel", [3, 16, 16])
    label = L.data("label", [1], dtype="int64")
    n = (depth - 2) // 6
    tmp = _conv_bn(L, images, 8, 3, 1, 1)
    for ch_in, ch_out, stride in ((8, 8, 1), (8, 16, 2), (16, 32, 2)):
        tmp = block(tmp, ch_in, ch_out, stride)
        for _ in range(1, n):
            tmp = block(tmp, ch_out, ch_out, 1)
    body = L.pool2d(tmp, 4, pool_type="avg", pool_stride=1)
    predict = L.fc(body, 10, act="softmax")
    avg_cost = L.mean(L.cross_entropy(predict, label))
    acc = L.accuracy(predict, label)
    S.optimizer.Adam(learning_rate=0.01).minimize(avg_cost)
    return [avg_cost, acc]


def test_image_classification_resnet():
    batches = []
    for i in range(3):
        rng = np.random.default_rng(100 + i)
        batches.append({"pixel": rng.normal(0, 1, (8, 3, 16, 16)).astype(
            np.float32), "label": rng.integers(0, 10, (8, 1))})
    jruns, truns = _train_both(_both(_resnet), batches)
    for j, t in zip(jruns, truns):
        np.testing.assert_array_equal(t[1], j[1])


SENT_DICT, SENT_LEN = 80, 10


def _sent_batch(i, b=8):
    rng = np.random.default_rng(200 + i)
    ids = rng.integers(8, SENT_DICT, (b, SENT_LEN)).astype(np.int64)
    lens = rng.integers(4, SENT_LEN + 1, (b,)).astype(np.int64)
    pos = rng.random(b) < 0.5
    for r, ln in enumerate(lens):
        ids[r, ln:] = 0
        if pos[r]:
            ids[r, rng.integers(0, ln)] = 7
    return {"words": ids, "seq_len": lens,
            "label": pos.astype(np.int64)[:, None]}


def _sentiment(S, L, lstm):
    words = L.data("words", [SENT_LEN], dtype="int64")
    seq_len = L.data("seq_len", [], dtype="int64")
    label = L.data("label", [1], dtype="int64")
    emb = L.embedding(words, (SENT_DICT, 16))
    if lstm:
        fc1 = L.fc(emb, 64, num_flatten_dims=2)
        lstm_h, _ = L.dynamic_lstm(fc1, 64, sequence_length=seq_len)
        feat = L.concat([L.sequence_pool(fc1, "max", seq_len),
                         L.sequence_pool(lstm_h, "max", seq_len)], axis=1)
    else:
        proj = L.fc(emb, 16, num_flatten_dims=2, act="tanh")
        feat = L.sequence_pool(proj, "max", seq_len)
    predict = L.fc(feat, 2, act="softmax")
    avg_cost = L.mean(L.cross_entropy(predict, label))
    S.optimizer.Adam(learning_rate=0.02).minimize(avg_cost)
    return [avg_cost, predict]


@pytest.mark.parametrize("lstm", [False, True], ids=["conv", "lstm"])
def test_understand_sentiment(lstm):
    _train_both(_both(lambda S, L: _sentiment(S, L, lstm)),
                [_sent_batch(i) for i in range(3)])


# -- label semantic roles (tests/test_book_label_semantic_roles.py) ----------

SRL_DICT, N_TAGS, EMB, HID, SLEN = 40, 5, 12, 12, 8


def _srl_batch(i, b=8):
    rng = np.random.default_rng(400 + i)
    words = rng.integers(1, SRL_DICT, (b, SLEN)).astype(np.int64)
    pred = rng.integers(0, SRL_DICT, (b, 1)).astype(np.int64)
    lens = rng.integers(3, SLEN + 1, (b,)).astype(np.int64)
    tags = (words % N_TAGS).astype(np.int64)
    for r, ln in enumerate(lens):
        words[r, ln:] = 0
        tags[r, ln:] = 0
    return {"word": words, "predicate": pred, "target": tags,
            "seq_len": lens}


def _srl(S, L):
    word = L.data("word", [SLEN], dtype="int64")
    predicate = L.data("predicate", [1], dtype="int64")
    seq_len = L.data("seq_len", [], dtype="int64")
    w_emb = L.embedding(word, (SRL_DICT, EMB), param_attr="word_emb")
    p_emb = L.embedding(predicate, (SRL_DICT, EMB), param_attr="pred_emb")
    feat = L.concat([w_emb, L.tile(p_emb, [1, SLEN, 1])], axis=2)
    proj = L.fc(feat, HID * 4, num_flatten_dims=2)
    fwd, _ = L.dynamic_lstm(proj, HID * 4, sequence_length=seq_len)
    bwd_r, _ = L.dynamic_lstm(L.sequence_reverse(proj, seq_len), HID * 4,
                              sequence_length=seq_len)
    bwd = L.sequence_reverse(bwd_r, seq_len)
    emission = L.fc(L.concat([fwd, bwd], axis=2), N_TAGS,
                    num_flatten_dims=2)
    target = L.data("target", [SLEN], dtype="int64")
    avg_cost = L.mean(L.linear_chain_crf(emission, target, seq_len,
                                         param_attr="crfw"))
    decode = L.crf_decoding(emission, seq_len, param_attr="crfw")
    S.optimizer.Adam(learning_rate=0.02).minimize(avg_cost)
    return [avg_cost, decode]


def test_label_semantic_roles_trains_and_decodes():
    jruns, truns = _train_both(_both(_srl),
                               [_srl_batch(i) for i in range(3)])
    for j, t in zip(jruns, truns):
        assert t[1].dtype.kind == "i"
        np.testing.assert_array_equal(t[1], j[1])


# -- machine translation (tests/test_book_machine_translation.py) ------------

MT_DICT, WORD_DIM, MT_HID, MT_BATCH, SRC_LEN, TRG_LEN, MAX_DECODE = \
    64, 16, 32, 8, 6, 5, 8


def _mt_batch(seed=3, n=MT_BATCH):
    rng = np.random.default_rng(seed)
    src = rng.integers(2, MT_DICT, (n, SRC_LEN)).astype(np.int64)
    src_len = rng.integers(3, SRC_LEN + 1, (n,)).astype(np.int64)
    for r, ln in enumerate(src_len):
        src[r, ln:] = 0
    key = src.sum(axis=1) % (MT_DICT - 2)
    trg = np.zeros((n, TRG_LEN), np.int64)
    for t in range(1, TRG_LEN):
        trg[:, t] = 2 + (key + t) % (MT_DICT - 2)
    trg_next = np.concatenate([trg[:, 1:], np.ones((n, 1), np.int64)], 1)
    return {"src_word_id": src, "src_len": src_len,
            "target_language_word": trg,
            "target_language_next_word": trg_next}


def _encoder(L):
    src = L.data("src_word_id", [SRC_LEN], "int64")
    src_len = L.data("src_len", [], "int64")
    emb = L.embedding(src, (MT_DICT, WORD_DIM), param_attr="vemb")
    fc1 = L.fc(emb, MT_HID * 4, num_flatten_dims=2, act="tanh")
    lstm_h, _ = L.dynamic_lstm(fc1, MT_HID * 4, sequence_length=src_len)
    return L.sequence_last_step(lstm_h, src_len)


def _mt_train(S, L):
    context = _encoder(L)
    trg = L.data("target_language_word", [TRG_LEN], "int64")
    trg_next = L.data("target_language_next_word", [TRG_LEN], "int64")
    emb_tm = L.transpose(L.embedding(trg, (MT_DICT, WORD_DIM),
                                     param_attr="vemb"), [1, 0, 2])
    rnn = S.StaticRNN()
    with rnn.step():
        word = rnn.step_input(emb_tm)
        pre = rnn.memory(init=context)
        state = L.fc(L.concat([word, pre], 1), MT_HID, act="tanh",
                     name="dec_state")
        score = L.fc(state, MT_DICT, act="softmax", name="dec_score")
        rnn.update_memory(pre, state)
        rnn.step_output(score)
    probs = L.transpose(rnn(), [1, 0, 2])
    cost = L.cross_entropy(L.reshape(probs, (-1, MT_DICT)),
                           L.reshape(trg_next, (-1, 1)))
    avg_cost = L.mean(cost)
    S.optimizer.Adam(learning_rate=0.01).minimize(avg_cost)
    return [avg_cost]


def _mt_decode(S, L, batch=MT_BATCH):
    context = _encoder(L)
    counter = L.fill_constant((1,), "int64", 0)
    limit = L.fill_constant((1,), "int64", MAX_DECODE)
    prev = L.fill_constant_batch_size_like(context, (context.shape[0],),
                                           "int64", 0)
    buf = L.fill_constant((MAX_DECODE, batch), "int64", 1)

    def body(t, state, word, buf):
        emb = L.embedding(word, (MT_DICT, WORD_DIM), param_attr="vemb")
        new_state = L.fc(L.concat([emb, state], 1), MT_HID, act="tanh",
                         name="dec_state")
        score = L.fc(new_state, MT_DICT, act="softmax", name="dec_score")
        nxt = L.argmax(score, axis=1)
        buf = L.scatter(buf, L.cast(t, "int64"), L.unsqueeze(nxt, [0]))
        return [S.increment(t, 1.0), new_state, nxt, buf]

    _, _, _, ids = S.while_loop(lambda t, s, w, b: S.less_than(t, limit),
                                body, [counter, context, prev, buf])
    return [ids]


def test_machine_translation_train():
    _train_both(_both(_mt_train), [_mt_batch(3 + i) for i in range(3)])


def test_machine_translation_greedy_decode():
    (_, jmain, _, jf, jexe, jscope), (_, tmain, _, tf, texe, tscope) = \
        _both(_mt_decode)
    feed = _mt_batch(9)
    feed = {k: feed[k] for k in ("src_word_id", "src_len")}
    want, = jexe.run(jmain, feed=feed, fetch_list=jf, scope=jscope)
    got, = texe.run(tmain, feed=feed, fetch_list=tf, scope=tscope)
    assert got.shape == (MAX_DECODE, MT_BATCH) and got.dtype.kind == "i"
    np.testing.assert_array_equal(got, want)
