"""Shared builders for the checker parity tests (shardcheck, memcheck):
the same program built with each package's DSL under fresh name counters,
and the same ``ShardingPlan`` on each package's mesh (the JAX mesh over
the virtual CPU devices, the port's by its dim sizes alone)."""
import numpy as np

import paddle_tpu.static as jstatic
import paddle_tpu_torch.static as tstatic

PKGS = (jstatic, tstatic)


def build(S, fn, *args, **kw):
    """(main, startup, fn's result) built with package ``S``."""
    S.framework._unique.counters = {}
    main, startup = S.Program(), S.Program()
    with S.program_guard(main, startup):
        out = fn(S, S.layers, *args, **kw)
    return main, startup, out


def mesh(S, n, axes=("dp",)):
    shape = (n,) if len(axes) == 1 else (n // 2, 2)
    if S is jstatic:
        import jax
        from jax.sharding import Mesh

        return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)
    from paddle_tpu_torch.parallel.mesh import Mesh

    return Mesh(axes, dict(zip(axes, shape)))


def plan(S, n=8, axes=("dp",), **kw):
    pkg = "paddle_tpu" if S is jstatic else "paddle_tpu_torch"
    import importlib

    sharding = importlib.import_module(pkg + ".parallel.sharding")
    return sharding.ShardingPlan(mesh=mesh(S, n, axes), **kw)


def diag_keys(diags):
    return [(d.code, d.severity, d.block, d.op_index, d.op_type, d.var,
             d.message, d.hint) for d in diags]


def tower(S, L, hidden=12, opt="sgd"):
    """tests/test_shardcheck.py's fc tower: params param_0 (8, hidden),
    param_1 (hidden,), param_2 (hidden, 1), param_3 (1,)."""
    x = L.data("x", [8])
    y = L.data("y", [1])
    h = L.fc(x, hidden, act="relu")
    loss = L.mean(L.square_error_cost(L.fc(h, 1), y))
    S.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def fc_tower(S, L, opt="sgd"):
    """tests/test_memcheck.py's fc tower."""
    x = L.data("x", [32])
    y = L.data("y", [1])
    h = L.fc(L.fc(x, 64, act="relu"), 64, act="relu")
    loss = L.mean(L.square_error_cost(L.fc(h, 1), y))
    o = (S.optimizer.Adam(learning_rate=0.01) if opt == "adam"
         else S.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
         if opt == "momentum" else S.optimizer.SGD(learning_rate=0.01))
    o.minimize(loss)
    return loss


def conv_block(S, L):
    """tests/test_memcheck.py's conv / BN residual block."""
    x = L.data("img", [3, 16, 16])
    y = L.data("y", [1])
    h = L.batch_norm(L.conv2d(x, 8, 3, padding=1), act="relu")
    h2 = L.batch_norm(L.conv2d(h, 8, 3, padding=1))
    h = L.pool2d(h + h2, pool_size=2, pool_type="avg", global_pooling=True)
    loss = L.mean(L.square_error_cost(L.fc(h, 1), y))
    S.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return loss


def embedding_net(S, L, vocab=4096, is_sparse=False):
    ids = L.data("ids", [16], dtype="int64")
    y = L.data("y", [1])
    emb = L.embedding(ids, size=(vocab, 32), is_sparse=is_sparse)
    h = L.layer_norm(L.fc(emb, 64, act="relu"))
    loss = L.mean(L.square_error_cost(L.fc(h, 1), y))
    S.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def wide(S, L, width, hidden, opt="sgd"):
    """One wide fc (MC002 / MC004 sizes)."""
    x = L.data("x", [width])
    y = L.data("y", [1])
    loss = L.mean(L.square_error_cost(L.fc(L.fc(x, hidden), 1), y))
    (S.optimizer.Adam(learning_rate=0.01) if opt == "adam"
     else S.optimizer.SGD(learning_rate=0.01)).minimize(loss)
    return loss
