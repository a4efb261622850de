"""`utils.pytree.dataclass`: the flax-free parameter containers flatten,
unflatten, replace, jit and vmap for every model family."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgmcmc_tpu.models.registry import get_model
from sgmcmc_tpu.utils import pytree

MODELS = ["svm", "svjm", "garch", "lgssm", "gauss_hmm", "arphmm", "slds"]


@pytree.dataclass
class Pair:
    a: jax.Array
    b: jax.Array

    @property
    def total(self):
        return self.a + self.b


def test_flatten_unflatten_and_replace():
    p = Pair(a=jnp.ones(2), b=jnp.zeros(3))
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert [x.shape for x in leaves] == [(2,), (3,)]
    q = jax.tree_util.tree_unflatten(treedef, [2 * x for x in leaves])
    assert isinstance(q, Pair) and float(q.a[0]) == 2.0
    r = p.replace(b=jnp.ones(3))
    assert float(r.b.sum()) == 3.0 and float(p.b.sum()) == 0.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.zeros(2)


def test_jit_vmap_over_dataclass():
    p = Pair(a=jnp.arange(4.0), b=jnp.ones(4))
    out = jax.jit(jax.vmap(lambda x: x.replace(a=x.total)))(p)
    np.testing.assert_allclose(np.asarray(out.a), np.arange(4.0) + 1.0)


@pytest.mark.parametrize("name", MODELS)
def test_model_params_are_pytrees(name):
    m = get_model(name)
    params = m.sample_prior(m.default_prior(), jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    assert leaves and type(params).__name__.endswith("Params")
    again = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(again) is type(params)
    stacked = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), params)
    doubled = jax.jit(jax.vmap(
        lambda p: jax.tree_util.tree_map(lambda x: 2 * x, p)))(stacked)
    for x, y in zip(jax.tree_util.tree_leaves(doubled), leaves):
        np.testing.assert_allclose(np.asarray(x[1]), 2 * np.asarray(y))
    field = dataclasses.fields(params)[0].name
    moved = params.replace(**{field: getattr(params, field) + 1})
    np.testing.assert_allclose(np.asarray(getattr(moved, field)),
                               np.asarray(getattr(params, field)) + 1)
