"""The dygraph gradient contracts of ``tests/test_tape_autograd.py``, held
for the port (torch autograd as the tape) on the CPU, with the JAX
package's tape run beside it where the two compute the same numbers.

Left out: ``test_hapi_model_tape_path`` (``hapi`` is not ported yet) and
the replay tape's own internals, ``test_orphaned_forward_chains_are_pruned``
and ``test_dead_leaves_are_swept`` (the port has no replay tape: torch
frees a graph with its last reference).  The reference's jit test becomes
``torch.func``: a functional transform over the op library records nothing
on the tape.  Where the two packages differ by design, the test says so:
torch records by default, where the JAX tape records only inside
``guard()``; ``Tensor.backward`` is torch's method (``dygraph.backward``
has the reference's ``grad_tensor`` and its non-scalar check).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpd
import paddle_tpu.dygraph as jdygraph
import paddle_tpu_torch as pd
import paddle_tpu_torch.dygraph as dygraph
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import autograd
from paddle_tpu_torch.optimizer import SGD, Adam


@pytest.fixture(autouse=True)
def _guard():
    with pd.device_guard("cpu"), dygraph.guard():
        yield


def test_leaf_grads_through_operators():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    with jdygraph.guard():
        jw = jpd.to_tensor(np.full((2, 3), 2.0, np.float32),
                           stop_gradient=False)
        jb = jpd.to_tensor(np.ones((2, 3), np.float32), stop_gradient=False)
        jpd.mean(jpd.to_tensor(x) * jw + jb).backward()
    w = pd.to_tensor(np.full((2, 3), 2.0, np.float32), stop_gradient=False)
    b = pd.to_tensor(np.ones((2, 3), np.float32), stop_gradient=False)
    xt = pd.to_tensor(x)
    loss = pd.mean(xt * w + b)
    assert not w.stop_gradient and xt.stop_gradient
    loss.backward()
    np.testing.assert_allclose(w.grad.numpy(),
                               np.arange(6).reshape(2, 3) / 6, rtol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jw.grad),
                               rtol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jb.grad),
                               rtol=1e-6)
    assert xt.grad is None  # stop_gradient leaf untouched


def test_grad_accumulates_until_cleared():
    w = pd.to_tensor(np.ones((3,), np.float32), stop_gradient=False)
    pd.sum(w * 2.0).backward()
    np.testing.assert_allclose(w.grad.numpy(), [2, 2, 2])
    pd.sum(w * 3.0).backward()
    np.testing.assert_allclose(w.grad.numpy(), [5, 5, 5])  # accumulated
    w.clear_gradient()
    assert w.grad is None


def test_backward_nonscalar_requires_grad_tensor():
    w = pd.to_tensor(np.ones((3,), np.float32), stop_gradient=False)
    y = w * 2.0
    with pytest.raises(ValueError, match="non-scalar"):
        dygraph.backward(y)
    with pytest.raises(RuntimeError):   # torch's method, torch's check
        y.backward()
    dygraph.backward(y, grad_tensor=np.array([1.0, 0.0, 2.0], np.float32))
    np.testing.assert_allclose(w.grad.numpy(), [2, 0, 4])


def test_retain_graph_double_backward_seed():
    w = pd.to_tensor(np.ones((2,), np.float32), stop_gradient=False)
    loss = pd.sum(w * w)
    loss.backward(retain_graph=True)
    loss.backward()  # second walk over the retained graph accumulates
    np.testing.assert_allclose(w.grad.numpy(), [4, 4])
    w2 = pd.to_tensor(np.ones((2,), np.float32), stop_gradient=False)
    loss2 = pd.sum(w2 * w2)
    dygraph.backward(loss2, retain_graph=True)
    dygraph.backward(loss2)
    np.testing.assert_allclose(w2.grad.numpy(), [4, 4])


def test_partial_grad_engine():
    with jdygraph.guard():
        jx = jpd.to_tensor(np.array([2.0, 3.0], np.float32),
                           stop_gradient=False)
        (jg,) = jdygraph.grad(jpd.sum(jx * jx * jx), jx)
    x = pd.to_tensor(np.array([2.0, 3.0], np.float32), stop_gradient=False)
    y = pd.sum(x * x * x)
    (g,) = dygraph.grad(y, x)
    np.testing.assert_allclose(g.numpy(), [12.0, 27.0], rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    assert x.grad is None           # .grad slots untouched
    # unused input: raises unless allow_unused
    z = pd.to_tensor(np.ones((2,), np.float32), stop_gradient=False)
    y2 = pd.sum(x * 2.0)
    with pytest.raises(ValueError, match="allow_unused"):
        dygraph.grad(y2, [z], retain_graph=True)
    gx, gz = dygraph.grad(y2, [x, z], allow_unused=True)
    np.testing.assert_allclose(gx.numpy(), [2.0, 2.0])
    assert gz is None


def test_no_grad_suppresses_recording():
    w = pd.to_tensor(np.ones((2,), np.float32), stop_gradient=False)
    with pd.no_grad():
        y = w * 5.0
    assert not y.requires_grad and y.grad_fn is None
    loss = pd.sum(y * w)  # y is a constant w.r.t. the tape
    loss.backward()
    np.testing.assert_allclose(w.grad.numpy(), [5, 5])


def _train_tape(model, xs, ys, lr, steps, to_tensor, mse, opt):
    losses = []
    for _ in range(steps):
        loss = mse(model(to_tensor(xs)), to_tensor(ys))
        loss.backward()
        opt.minimize(loss)
        model.clear_gradients()
        losses.append(float(loss))
    return losses


def test_tape_matches_functional_path():
    """A book-style dygraph loop trains to the same numbers as
    ``autograd`` + a functional update, and as the JAX package's tape
    from the same weights."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.nn import functional as JF
    from paddle_tpu.optimizer import SGD as JSGD

    rng = np.random.RandomState(7)
    xs = rng.rand(16, 4).astype(np.float32)
    ys = (xs @ rng.rand(4, 2).astype(np.float32) + 0.3).astype(np.float32)
    with jdygraph.guard():
        jpd.seed(42)
        jm = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 2))
        state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
        jlosses = _train_tape(jm, xs, ys, 0.05, 10, jpd.to_tensor,
                              JF.mse_loss,
                              JSGD(learning_rate=0.05,
                                   parameters=jm.parameters()))

    def build():
        m = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 2))
        assert m.set_state_dict(state) == ([], [])
        return m

    m = build()
    tape_losses = _train_tape(m, xs, ys, 0.05, 10, pd.to_tensor, F.mse_loss,
                              SGD(learning_rate=0.05,
                                  parameters=m.parameters()))
    np.testing.assert_allclose(tape_losses, jlosses, rtol=1e-4)

    model = build()
    opt = SGD(learning_rate=0.05)
    params = autograd.parameters_dict(model)
    st = opt.init(params)

    def loss_fn(p):
        out = autograd.functional_call(model, p, (pd.to_tensor(xs),))
        return pd.mean((out - pd.to_tensor(ys)) ** 2)

    fn_losses = []
    for _ in range(10):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = loss_fn(leaves)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        params, st = opt.update(grads, st, params)
        fn_losses.append(float(loss))
    np.testing.assert_allclose(tape_losses, fn_losses, rtol=1e-6)


def test_mnist_book_loop_adam():
    """ref book test_mnist dygraph: conv net + Adam + cross_entropy, the
    canonical `loss.backward(); opt.minimize(loss)` loop -- loss must
    fall."""
    pd.seed(1)

    class MNIST(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(1, 4, 3, padding=1)
            self.fc = nn.Linear(4 * 7 * 7, 10)

        def forward(self, x):
            x = F.relu(self.conv(x))
            x = F.max_pool2d(x, kernel_size=2, stride=2)
            x = pd.reshape(x, (x.shape[0], -1))
            return self.fc(x)

    model = MNIST()
    opt = Adam(learning_rate=1e-3, parameters=model.parameters())
    rng = np.random.RandomState(0)
    xs = rng.rand(16, 1, 14, 14).astype(np.float32)
    ys = rng.randint(0, 10, (16, 1))
    first = last = None
    for _ in range(8):
        logits = model(pd.to_tensor(xs))
        loss = pd.mean(F.cross_entropy(logits, pd.to_tensor(ys)))
        loss.backward()
        opt.minimize(loss)
        model.clear_gradients()
        first = float(loss) if first is None else first
        last = float(loss)
    assert last < first, (first, last)


def test_dropout_mask_reaches_the_gradient():
    """The reference replays the forward with the recorded RNG state; torch
    autograd keeps the forward's mask: either way the gradient is the
    eager forward's mask over the keep probability."""
    pd.seed(123)
    w = pd.to_tensor(np.ones((64,), np.float32), stop_gradient=False)
    y = F.dropout(w * 2.0, p=0.5, training=True)
    mask = (y.detach().numpy() != 0).astype(np.float32)
    assert 0 < mask.sum() < 64
    pd.sum(y).backward()
    np.testing.assert_allclose(w.grad.numpy(), 2.0 * mask / 0.5, rtol=1e-6)


def test_optimizer_step_none_and_clear_grad():
    lin = nn.Linear(2, 2)
    opt = Adam(learning_rate=0.01, parameters=lin.parameters())
    with pytest.raises(ValueError, match="backward"):
        opt.step()
    loss = pd.sum(lin(pd.to_tensor(np.ones((1, 2), np.float32))))
    loss.backward()
    before = lin.weight.numpy().copy()
    opt.step()
    assert not np.allclose(before, lin.weight.numpy())
    opt.clear_grad()
    assert all(p.grad is None for p in lin.parameters())


def test_grad_scaler_tape_mode():
    from paddle_tpu_torch.amp import GradScaler

    lin = nn.Linear(2, 1)
    opt = SGD(learning_rate=0.1, parameters=lin.parameters())
    scaler = GradScaler(init_loss_scaling=1024.0)
    loss = pd.mean(lin(pd.to_tensor(np.ones((4, 2), np.float32))) ** 2)
    scaled = scaler.scale(loss)
    scaled.backward()
    did_step = scaler.minimize(opt)
    assert did_step
    scaler.update()
    # the applied grads were unscaled: finite, of the loss's own size
    g = lin.weight.grad
    assert g is None or bool(torch.isfinite(g).all())


def test_grad_mode_is_the_tape_switch():
    """The port's tape is torch's grad mode: ``disable_tape`` stops
    recording, ``guard`` turns it on and restores it, and making a leaf
    (``stop_gradient=False``) is not a mode switch.  Unlike the JAX tape,
    recording is on by default, outside any guard."""
    assert dygraph.enabled()
    dygraph.disable_tape()
    try:
        t = pd.to_tensor(np.ones((2,), np.float32), stop_gradient=False)
        assert not dygraph.enabled()
        assert not (t * 2.0).requires_grad
        with dygraph.guard():
            assert dygraph.enabled() and (t * 2.0).requires_grad
        assert not dygraph.enabled()
    finally:
        dygraph.enable_tape()  # restore for the autouse guard fixture
    assert dygraph.enable_dygraph is dygraph.enable_tape
    assert dygraph.disable_dygraph is dygraph.disable_tape
    v = dygraph.to_variable(np.ones((2,), np.float64))
    assert v.dtype == torch.float32 and v.stop_gradient


def test_grad_scaler_minimize_accepts_scaled_loss_tensor():
    """The reference AmpScaler.minimize(optimizer, scaled_loss)
    contract."""
    from paddle_tpu_torch.amp import GradScaler

    lin = nn.Linear(2, 1)
    opt = SGD(learning_rate=0.1, parameters=lin.parameters())
    scaler = GradScaler(init_loss_scaling=256.0)
    scaled = scaler.scale(
        pd.mean(lin(pd.to_tensor(np.ones((4, 2), np.float32))) ** 2))
    scaled.backward()
    before = lin.weight.numpy().copy()
    assert scaler.minimize(opt, scaled)  # loss tensor, not a grads list
    assert not np.allclose(before, lin.weight.numpy())


def test_functional_transform_records_nothing():
    """The reference's jit test: under a functional transform the op
    library composes and the tape's leaf slots stay untouched."""
    w = pd.to_tensor(np.ones((3,), np.float32), stop_gradient=False)
    g = torch.func.grad(lambda a: pd.sum(a * 2.0))(w)
    np.testing.assert_array_equal(g.numpy(), [2.0, 2.0, 2.0])
    assert w.grad is None
    jg = np.asarray(__import__("jax").grad(
        lambda a: jpd.sum(a * 2.0))(jnp.ones((3,), jnp.float32)))
    np.testing.assert_array_equal(g.numpy(), jg)
