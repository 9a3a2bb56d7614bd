"""The port's decode fast path pieces against JAX's: the n-gram drafter,
multi-token paged attention and the fused sampler.

- ``serve.draft.propose`` equals JAX's on seeded random and periodic
  histories (exact);
- ``ops.attention.paged_verify_attention`` matches JAX's on random
  pools, page tables and lengths, with and without GQA (fp32, 1e-5
  relative);
- ``serve.sampling.sample_burst`` in greedy mode equals JAX's exactly
  (accepted prefix, bonus token, ``next_feed``) on crafted logits;
- with temperature, the acceptance rate of a deterministic draft over
  4096 seeds is within 4 standard deviations of the draft's target
  probability, and the emitted tokens follow the target distribution;
- the same seed on the same logits gives the same tokens twice (the
  port's draws are Philox of (seed, position), not JAX's folded keys, so
  sampled tokens match JAX only in distribution).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.ops.attention import (
    paged_verify_attention as jax_paged_verify_attention,
)
from distributedtensorflow_tpu.serve import draft as jax_draft
from distributedtensorflow_tpu.serve import sampling as jax_sampling
from distributedtensorflow_tpu_torch.ops.attention import (
    paged_decode_attention,
    paged_verify_attention,
)
from distributedtensorflow_tpu_torch.serve import draft, sampling

# ------------------------------------------------------------ n-gram drafter


@pytest.mark.parametrize("seed", range(4))
def test_propose_equals_jax_on_random_and_periodic_histories(seed):
    rng = np.random.default_rng(seed)
    histories = [list(rng.integers(0, vocab, n))
                 for vocab in (3, 5, 50) for n in (0, 1, 2, 7, 40)]
    period = [int(t) for t in rng.integers(0, 50, int(rng.integers(2, 6)))]
    histories += [(period * 12)[:n] for n in (3, 9, 17, 31)]
    histories += [(period * 6)[:20] + [int(rng.integers(0, 50))]]
    for h in histories:
        for k in (0, 1, 4):
            for max_ngram, min_ngram in ((3, 1), (3, 2), (1, 1), (5, 2)):
                got = draft.propose(h, k, max_ngram=max_ngram,
                                    min_ngram=min_ngram)
                want = jax_draft.propose(h, k, max_ngram=max_ngram,
                                         min_ngram=min_ngram)
                assert got == want, (h, k, max_ngram, min_ngram)
    # a periodic tail drafts its continuation
    assert draft.propose(period * 3, 4) == period[:4]


# ---------------------------------------------- multi-token paged attention


def _pool_case(rng, b, t, h, h_kv, d, bs, max_blocks, nb):
    pool_k = rng.standard_normal((nb, bs, h_kv, d)).astype(np.float32)
    pool_v = rng.standard_normal((nb, bs, h_kv, d)).astype(np.float32)
    tables = rng.integers(0, nb, (b, max_blocks)).astype(np.int32)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    lens = rng.integers(1, max_blocks * bs - t + 2, b).astype(np.int32)
    return q, pool_k, pool_v, tables, lens


@pytest.mark.parametrize("h,h_kv,t", [(4, 4, 3), (4, 2, 5), (6, 1, 2),
                                      (4, 4, 1)])
def test_paged_verify_attention_matches_jax(h, h_kv, t):
    rng = np.random.default_rng(h * 10 + h_kv + t)
    q, pk, pv, tables, lens = _pool_case(rng, 3, t, h, h_kv, 8, 4, 5, 12)
    want = np.asarray(jax_paged_verify_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(lens)))
    got = paged_verify_attention(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(tables).long(), torch.from_numpy(lens).long())
    assert got.shape == (3, t, h, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if t == 1:  # reduces to the one-token paged decode
        one = paged_decode_attention(
            torch.from_numpy(q[:, 0]), torch.from_numpy(pk),
            torch.from_numpy(pv), torch.from_numpy(tables).long(),
            torch.from_numpy(lens).long())
        np.testing.assert_allclose(got[:, 0].numpy(), one.numpy(),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- fused sampler


def _jax_burst(logits, tokens, draft_lens, temperature, top_k, active,
               sample_pos=None):
    b = logits.shape[0]
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b))
    out = jax_sampling.sample_burst(
        jnp.asarray(logits), jnp.asarray(tokens, jnp.int32),
        jnp.asarray(draft_lens, jnp.int32), keys,
        jnp.zeros((b,), jnp.int32) if sample_pos is None
        else jnp.asarray(sample_pos, jnp.int32),
        jnp.asarray(temperature, jnp.float32),
        jnp.asarray(top_k, jnp.int32), jnp.asarray(active))
    return [np.asarray(x) for x in out]


def _burst(logits, tokens, draft_lens, temperature, top_k, active,
           seeds=None, sample_pos=None, all_greedy=None):
    b = logits.shape[0]
    out = sampling.sample_burst(
        torch.as_tensor(logits), torch.as_tensor(tokens).long(),
        torch.as_tensor(draft_lens).long(),
        torch.arange(b) if seeds is None else torch.as_tensor(seeds).long(),
        torch.zeros(b, dtype=torch.long) if sample_pos is None
        else torch.as_tensor(sample_pos).long(),
        torch.as_tensor(temperature, dtype=torch.float32),
        torch.as_tensor(top_k).long(), torch.as_tensor(active),
        all_greedy=all_greedy)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("all_greedy", [True, None])
def test_sample_burst_greedy_equals_jax(all_greedy):
    """Crafted logits whose argmaxes accept 0, 1, 2 and all 3 drafts, an
    inactive slot and a short draft: accepted prefix, bonus token and
    next_feed equal JAX's exactly."""
    b, t, v = 6, 4, 11
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    target = rng.integers(0, v, (b, t))
    for i in range(b):
        for j in range(t):
            logits[i, j, target[i, j]] = 10.0
    tokens = np.zeros((b, t), np.int64)
    tokens[:, 0] = rng.integers(0, v, b)
    tokens[:, 1:] = target[:, :-1]
    tokens[0, 1] = (target[0, 0] + 1) % v      # rejects the first draft
    tokens[1, 2] = (target[1, 1] + 1) % v      # accepts one
    tokens[2, 3] = (target[2, 2] + 1) % v      # accepts two
    draft_lens = np.array([3, 3, 3, 3, 3, 1])  # row 3 accepts all three
    active = np.array([True, True, True, True, False, True])
    temp, top_k = np.zeros(b, np.float32), np.zeros(b, np.int64)
    got = _burst(logits, tokens, draft_lens, temp, top_k, active,
                 all_greedy=all_greedy)
    want = _jax_burst(logits, tokens, draft_lens, temp, top_k, active)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].tolist() == [1, 2, 3, 4, 0, 2]
    # a mixed batch: the greedy rows' choices do not change
    temp_mixed = temp.copy()
    temp_mixed[4] = 0.9
    mixed = _burst(logits, tokens, draft_lens, temp_mixed, top_k, active)
    for g, m in zip(got, mixed):
        np.testing.assert_array_equal(g, m)


def test_sample_burst_acceptance_and_distribution():
    """4096 seeded draws on one logits row, T = 2: a likely, an unlikely
    and no draft.  The acceptance rate of a draft is within 4 standard
    deviations of its target probability p(d), and the first emitted
    token's frequencies match the target distribution (4 standard
    deviations a bin)."""
    n, v = 4096, 8
    rng = np.random.default_rng(1)
    row = rng.standard_normal((v,)).astype(np.float32) * 1.5
    target = jax_sampling.logits_to_probs(row, 1.0, 0, xp=np)
    logits = np.broadcast_to(row, (n, 2, v)).copy()
    temp, top_k = np.ones(n, np.float32), np.zeros(n, np.int64)
    active = np.ones(n, bool)
    seeds = np.arange(n) + 12345
    for d, dl in ((int(np.argmax(target)), 1), (int(np.argmin(target)), 1),
                  (0, 0)):
        tokens = np.tile(np.array([[3, d]]), (n, 1))
        out, n_emit, _ = _burst(logits, tokens, np.full(n, dl), temp, top_k,
                                active, seeds=seeds)
        freq = np.bincount(out[:, 0], minlength=v) / n
        sd = np.sqrt(target * (1 - target) / n)
        assert np.all(np.abs(freq - target) <= 4 * sd + 1e-9), (freq, target)
        if dl:
            acc = (n_emit == 2).mean()
            p = target[d]
            assert abs(acc - p) <= 4 * np.sqrt(p * (1 - p) / n), (acc, p)


def test_same_seed_same_tokens_and_top_k():
    """The draws are a pure function of (seed, position): the same call
    twice gives the same tokens, another seed or position other tokens,
    and top-k never emits a token outside the k largest."""
    b, t, v = 64, 3, 50
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    tokens = rng.integers(0, v, (b, t))
    args = (logits, tokens, np.full(b, t - 1), np.full(b, 0.8, np.float32),
            np.full(b, 5), np.ones(b, bool))
    a = _burst(*args, seeds=np.arange(b))
    again = _burst(*args, seeds=np.arange(b))
    for x, y in zip(a, again):
        np.testing.assert_array_equal(x, y)
    other = _burst(*args, seeds=np.arange(b) + 1)
    moved = _burst(*args, seeds=np.arange(b), sample_pos=np.full(b, 7))
    assert not np.array_equal(a[0], other[0])
    assert not np.array_equal(a[0], moved[0])
    top5 = np.argsort(logits, axis=-1)[..., -5:]
    out, n_emit, _ = a
    for i in range(b):
        j = n_emit[i] - 1  # the sampled (correction or bonus) position
        assert out[i, j] in top5[i, j]
    u = sampling.uniforms(torch.tensor([sampling.seed_word(-1), 2**40]),
                          torch.arange(6).reshape(2, 3))
    assert u.shape == (2, 3, 2) and bool(((u >= 0) & (u < 1)).all())


def test_sample_one_matches_burst_and_greedy_argmax():
    rng = np.random.default_rng(3)
    row = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    assert sampling.sample_one(row, 5, 0, 0.0, 0) == int(row.argmax())
    draws = {sampling.sample_one(row, s, 0, 1.0, 3) for s in range(64)}
    assert draws <= set(torch.topk(row, 3).indices.tolist())
    assert len(draws) > 1
    out, _, _ = _burst(row.numpy()[None, None], np.zeros((1, 1)),
                       np.zeros(1), np.ones(1, np.float32), np.full(1, 3),
                       np.ones(1, bool), seeds=[9], sample_pos=[4])
    assert sampling.sample_one(row, 9, 4, 1.0, 3) == out[0, 0]
