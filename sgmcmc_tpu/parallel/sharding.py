"""Device-mesh parallelism for SG-MCMC: chains x particles.

The reference's only parallelism is independent shell jobs
(`/root/reference/sgmcmc_ssm/driver_utils.py:69-111`).  Here the same axes
are first-class mesh dimensions (SURVEY.md §2.4):

* ``chain`` — the data-parallel axis of SG-MCMC: independent chains, sharded
  across devices with `shard_map`; zero cross-chain communication.
* ``particle`` — the tensor-parallel analogue: one particle filter's N
  particles sharded across devices, with `all_gather`/`psum` collectives for
  resampling and log-normalization (see `pf_shard.py`).

Multi-host runs extend the same mesh across hosts via `jax.distributed`;
chain parallelism needs no communication, so the chain axis spans hosts and
particle collectives stay within a host's NVLink-joined GPUs.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_multi_host(coordinator_address: str | None = None,
                          num_processes: int | None = None,
                          process_id: int | None = None) -> Mesh:
    """Bootstrap a multi-host run and return the global (chain, particle=1)
    mesh.

    Thin wrapper over `jax.distributed.initialize` (SURVEY.md §2.4: the
    chain axis spans hosts with zero communication, so the default global
    mesh puts every device on the chain axis).  Pass the arguments
    explicitly (``coordinator_address="localhost:<port>"`` for processes of
    one host): nothing auto-detects a GPU cluster.  Call once per process
    before any jax computation; then build custom meshes with `make_mesh`
    if particle sharding is wanted.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return make_mesh(n_chain_devices=len(jax.devices()),
                     n_particle_devices=1)


def make_mesh(n_chain_devices: int | None = None,
              n_particle_devices: int = 1,
              devices=None) -> Mesh:
    """Build a (chain, particle) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_chain_devices is None:
        n_chain_devices = len(devices) // n_particle_devices
    n = n_chain_devices * n_particle_devices
    grid = np.asarray(devices[:n]).reshape(n_chain_devices,
                                           n_particle_devices)
    return Mesh(grid, ("chain", "particle"))


def shard_chain_states(mesh: Mesh, tree):
    """Place a pytree of per-chain stacked states with the leading axis
    sharded over the 'chain' mesh axis."""
    sharding = NamedSharding(mesh, P("chain"))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree)


def chain_parallel_step(step_fn, mesh: Mesh):
    """Lift step_fn(key, params, observations) -> (params, aux) to many
    chains sharded over the mesh's 'chain' axis.

    Inside each shard the local chains are vmapped; observations are
    replicated (every chain reads the same series — the reference's
    experiment grid runs many samplers on shared data).
    """
    from jax import shard_map

    vstep = jax.vmap(step_fn, in_axes=(0, 0, None))
    sharded = shard_map(
        vstep, mesh=mesh,
        in_specs=(P("chain"), P("chain"), P()),
        out_specs=(P("chain"), P("chain")),
        check_vma=False,
    )
    return sharded


def chain_parallel_fit(step_fn, mesh: Mesh, num_iters: int,
                       project_fn=None):
    """Build fit(keys[n_chains], params_stack, observations) running
    ``num_iters`` sharded steps under one jit/scan."""
    pstep = chain_parallel_step(step_fn, mesh)

    def fit(keys, params_stack, observations):
        def body(carry, i):
            params = carry
            step_keys = jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
            params, aux = pstep(step_keys, params, observations)
            if project_fn is not None:
                params = jax.vmap(project_fn)(params)
            return params, aux

        import jax.numpy as jnp
        return jax.lax.scan(body, params_stack,
                            jnp.arange(num_iters, dtype=jnp.int32))

    return jax.jit(fit)
