"""The port's fused loss and gradient ops against luminaai_tpu/ops/fused.py.

Same numpy-seeded fp32 inputs on both sides, with a loss mask, per-token
weights, z-loss and label smoothing, and a sequence length that is not a
multiple of the chunk size (the chunk then shrinks to a divisor, as in
JAX). Loss, every metric, and the gradients with respect to the logits or
to the hidden rows and the embedding table are compared at rtol 1e-5 /
atol 1e-6 (fp32; logsumexp and the chunked sums run in other orders).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from luminaai_tpu.ops import fused as jf
from luminaai_tpu_torch.ops import fused as tf

TOL = dict(rtol=1e-5, atol=1e-6)
B, S, H, V = 2, 40, 32, 96


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return dict(
        hidden=rng.randn(B, S, H).astype(np.float32),
        embedding=(rng.randn(V, H) * 0.3).astype(np.float32),
        logits=(rng.randn(B, S, V) * 2).astype(np.float32),
        labels=rng.randint(0, V, size=(B, S)).astype(np.int32),
        mask=(rng.rand(B, S) > 0.2).astype(np.float32),
        weights=rng.choice([1.0, 1.5], size=(B, S)).astype(np.float32),
    )


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL,
                                   err_msg=k)


OPTIONS = {
    "plain": dict(),
    "mask_weights": dict(mask=True, weights=True),
    "z_loss_smoothing": dict(mask=True, weights=True, z_loss_weight=1e-3,
                             label_smoothing=0.1),
}


@pytest.mark.parametrize("opts", sorted(OPTIONS))
def test_cross_entropy_matches_jax(opts):
    o = OPTIONS[opts]
    x = _inputs(1)
    kw = dict(z_loss_weight=o.get("z_loss_weight", 0.0),
              label_smoothing=o.get("label_smoothing", 0.0))
    mask = x["mask"] if o.get("mask") else None
    weights = x["weights"] if o.get("weights") else None

    def jloss(logits):
        return jf.cross_entropy_loss(
            logits, jnp.asarray(x["labels"]),
            None if mask is None else jnp.asarray(mask),
            None if weights is None else jnp.asarray(weights), **kw)

    (loss_j, metrics_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x["logits"]))
    logits = torch.tensor(x["logits"], requires_grad=True)
    loss_t, metrics_t = tf.cross_entropy_loss(
        logits, torch.as_tensor(x["labels"]),
        None if mask is None else torch.as_tensor(mask),
        None if weights is None else torch.as_tensor(weights), **kw)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)
    _assert_metrics(metrics_t, metrics_j)
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(g_j), **TOL)


@pytest.mark.parametrize("chunk", [16, 256])
@pytest.mark.parametrize("opts", sorted(OPTIONS))
def test_fused_lm_head_cross_entropy_matches_jax(opts, chunk):
    o = OPTIONS[opts]
    x = _inputs(2)
    kw = dict(z_loss_weight=o.get("z_loss_weight", 0.0),
              label_smoothing=o.get("label_smoothing", 0.0),
              chunk_size=chunk)
    mask = x["mask"] if o.get("mask") else None
    weights = x["weights"] if o.get("weights") else None

    def jloss(hidden, embedding):
        return jf.fused_lm_head_cross_entropy(
            hidden, embedding, jnp.asarray(x["labels"]),
            None if mask is None else jnp.asarray(mask),
            None if weights is None else jnp.asarray(weights), **kw)

    (loss_j, metrics_j), (gh_j, ge_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x["hidden"]), jnp.asarray(x["embedding"]))
    hidden = torch.tensor(x["hidden"], requires_grad=True)
    embedding = torch.tensor(x["embedding"], requires_grad=True)
    loss_t, metrics_t = tf.fused_lm_head_cross_entropy(
        hidden, embedding, torch.as_tensor(x["labels"]),
        None if mask is None else torch.as_tensor(mask),
        None if weights is None else torch.as_tensor(weights), **kw)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)
    _assert_metrics(metrics_t, metrics_j)
    np.testing.assert_allclose(hidden.grad.numpy(), np.asarray(gh_j), **TOL)
    np.testing.assert_allclose(embedding.grad.numpy(), np.asarray(ge_j),
                               **TOL)


def test_fused_equals_unfused_in_the_port():
    x = _inputs(3)
    hidden = torch.as_tensor(x["hidden"])
    emb = torch.as_tensor(x["embedding"])
    labels = torch.as_tensor(x["labels"])
    fused, _ = tf.fused_lm_head_cross_entropy(hidden, emb, labels,
                                              chunk_size=7)
    plain, _ = tf.cross_entropy_loss(hidden @ emb.t(), labels)
    np.testing.assert_allclose(fused.item(), plain.item(), **TOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "passes"])
def test_global_norm_and_clip_match_jax(max_norm):
    rng = np.random.RandomState(4)
    grads = [rng.randn(*s).astype(np.float32)
             for s in ((7, 5), (11,), (3, 4, 2))]
    clipped_j, norm_j = jf.clip_by_global_norm(
        [jnp.asarray(g) for g in grads], max_norm)
    clipped_t, norm_t = tf.clip_by_global_norm(
        [torch.as_tensor(g) for g in grads], max_norm)
    np.testing.assert_allclose(norm_t.item(), float(norm_j), **TOL)
    np.testing.assert_allclose(
        tf.global_norm([torch.as_tensor(g) for g in grads]).item(),
        float(jf.global_norm([jnp.asarray(g) for g in grads])), **TOL)
    for got, want in zip(clipped_t, clipped_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
