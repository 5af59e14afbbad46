"""The port's op-coverage table (paddle_tpu_torch/static/op_coverage.py)
against the JAX package's: the same DESCOPED rationale table, no entry of
it registered in the port either, and the two registries plus the table
accounting for the same op names (the port counterpart of
tests/test_registry_exhaustive.py, whose reference-tree grep needs the
reference checkout)."""
import paddle_tpu.static.executor  # noqa: F401 — registers the JAX ops
import paddle_tpu_torch.static.executor  # noqa: F401 — registers the port's
from paddle_tpu.static.op_coverage import DESCOPED as JAX_DESCOPED
from paddle_tpu.static.registry import registered_ops as jax_ops
from paddle_tpu_torch.static.op_coverage import DESCOPED
from paddle_tpu_torch.static.registry import registered_ops as port_ops


def test_descoped_table_is_the_jax_table():
    assert DESCOPED == JAX_DESCOPED
    assert list(DESCOPED) == list(JAX_DESCOPED)


def test_descope_table_has_no_stale_entries():
    """An op with a lowering is not descoped (``None`` marks an entry the
    table keeps only to say where the op is registered)."""
    stale = sorted(n for n in set(DESCOPED) & set(port_ops())
                   if DESCOPED[n] is not None)
    assert stale == sorted(n for n in set(JAX_DESCOPED) & set(jax_ops())
                           if JAX_DESCOPED[n] is not None)
    assert not stale, stale


def test_registries_and_table_account_for_the_same_names():
    port = set(port_ops()) | set(DESCOPED)
    jax = set(jax_ops()) | set(JAX_DESCOPED)
    assert port == jax
    assert not set(port_ops()) - set(jax_ops())
