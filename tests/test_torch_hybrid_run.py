"""Jamba-1.5-Large's runs in the port against the JAX package, on the CPU:
the attention layer on the flash route, the gradients of the mean loss and
three trainer steps.

The smoke config (fp32; one hybrid period of 8 layers) with weights from the
JAX ``LM.init`` (seed 0) through ``bridge.params_from_jax``.  On the flash
route the JAX side runs its Pallas kernels in interpret mode and the port's
wrappers take their plain versions (the SSD's too).  The tolerance is fp32
2e-5; the trainers' as ``tests/test_torch_archs_run.py``'s.  Split from
``tests/test_torch_hybrid.py`` so that the two files run on two workers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_archs import _assert_trees_close, _batch, _np, _port_grads, _torch_batch
from test_torch_archs_run import three_trainer_steps
from test_torch_hybrid import ARCH, TOL, _pair, weights  # noqa: F401 (the module fixture)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)


def test_attention_layer_on_flash_route_matches_jax(weights):
    """``attn_impl="flash"``: the attention layer through the port's kernel
    wrappers (their plain versions) against JAX's Pallas kernels in
    interpret mode, in a stack of Mamba-2 layers, on a packed batch (the
    kernels' segment mask): logits, and the gradients of the mean loss,
    which hold the hybrid stack's backward (the Mamba-2 and MoE layers'
    too)."""
    jmodel, model, params = _pair(weights, attn_impl="flash", attn_grid="dense")
    batch = _batch(model.cfg, seed=14, s=64)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, jgrads = jax.jit(lambda p: (
        jmodel.forward(p, jbatch), jax.grad(lambda q: jnp.divide(*jmodel.loss_sums(q, jbatch)))(p)))(
        jax.tree.map(jnp.asarray, weights))
    with torch.no_grad():
        logits = model.forward(params, _torch_batch(batch))
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    _, _, tgrads = _port_grads(model, params, batch)
    _assert_trees_close(tgrads, jgrads, **TOL)


def test_trainer_three_steps_match_jax(weights):
    """Three JAX and port trainer steps on the packed layout, the attention
    layer on the flash pruned route (interpret Pallas / plain versions)."""
    three_trainer_steps(ARCH, weights, attn_impl="flash", attn_grid="pruned")
