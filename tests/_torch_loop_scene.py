"""Shared inputs of the port's loop-closing and relocalization parity tests:
the reference's ``jax.random`` draws for the RANSAC solvers, and maps built
by the JAX package's own fixtures carried across as numpy arrays.

Importing this module caps torch's intra-op threads at 2 (as
``_torch_scene.py`` does, for the same reason)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpuslam_torch.map import mapstate as tms

torch.set_num_threads(2)


def jax_draw(valid, seed: int, n_iters: int, k: int):
    """The reference's RANSAC draw: per iteration the ``k`` largest of Gumbel
    noise plus -1e9 on invalid entries, keys split from ``PRNGKey(seed)``
    (sim3solver.py:73-77, pnp.py:64-68)."""
    valid = np.asarray(valid)
    keys = jax.random.split(jax.random.PRNGKey(int(seed)), n_iters)
    pen = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    g = jax.vmap(lambda key: jax.random.gumbel(key, (valid.shape[0],)))(keys) + pen
    return np.asarray(jax.lax.top_k(g, k)[1])


def torch_draw(valid, seed: int, n_iters: int, k: int):
    """:func:`jax_draw` as the port's solvers take it."""
    return torch.from_numpy(jax_draw(valid.cpu().numpy(), seed, n_iters, k).astype(np.int64))


def t(a):
    return tms.tensor_from_numpy(np.asarray(a), "cpu")


def tmap(m_j):
    return tms.map_from_numpy({k: np.asarray(getattr(m_j, k)) for k in m_j._fields}, "cpu")
