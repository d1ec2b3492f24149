"""The port's sampler against the JAX package's.

- greedy rows are exact (argmax);
- the top-k / top-p filter keeps exactly the tokens JAX's filtered
  sampler can draw: JAX's support is read off 4000 draws with 4000 keys
  over a vocabulary small enough that every kept token has >= 1% mass;
- temperature sampling draws from softmax(logits / T): the port's
  ``torch.Generator`` stream differs from ``jax.random``'s, so this is a
  distribution test (total variation < 0.05 over 4000 draws, for both
  packages against the exact distribution);
- penalties and logit_bias rows are the same arithmetic (f32, exact).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.workloads.serving import sampler as jsampler
from k8s_runpod_kubelet_tpu_torch.workloads.serving import sampler

N_DRAWS = 4000


def test_greedy_rows_are_exact():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, 300)).astype(np.float32)
    out = sampler._sample(torch.from_numpy(logits), [1] * 5, [0] * 5,
                          [0.0] * 5)
    ref = jsampler._sample(jnp.asarray(logits),
                           jsampler._row_keys(jnp.arange(5, dtype=jnp.uint32),
                                              jnp.zeros(5, jnp.int32)),
                           [0.0] * 5)
    assert out == np.asarray(ref).tolist() == logits.argmax(-1).tolist()
    # a greedy row inside a sampled batch stays greedy
    mixed = sampler._sample(torch.from_numpy(logits), [1] * 5, [0] * 5,
                            [0.0, 1.0, 0.0, 1.0, 0.0])
    assert [mixed[i] for i in (0, 2, 4)] == \
        [int(logits[i].argmax()) for i in (0, 2, 4)]


FILTERS = {"topk3": (3, 1.0), "topk8": (8, 1.0), "topp50": (0, 0.5),
           "topp90": (0, 0.9), "topk6_topp80": (6, 0.8), "topk1": (1, 1.0)}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_keeps_exactly_what_jax_can_draw(name):
    top_k, top_p = FILTERS[name]
    v = 16
    logits = np.linspace(2.0, -2.0, v).astype(np.float32)
    logits = logits[np.random.default_rng(1).permutation(v)]
    batch = np.tile(logits, (N_DRAWS, 1))
    keys = jsampler._row_keys(jnp.arange(N_DRAWS, dtype=jnp.uint32),
                              jnp.zeros(N_DRAWS, jnp.int32))
    drawn = jsampler._sample_filtered(
        jnp.asarray(batch), keys, jnp.ones(N_DRAWS, jnp.float32),
        jnp.full(N_DRAWS, top_k, jnp.int32),
        jnp.full(N_DRAWS, top_p, jnp.float32))
    jax_support = set(np.asarray(drawn).tolist())
    kept = sampler._filter(torch.from_numpy(logits)[None],
                           torch.tensor([top_k]), torch.tensor([top_p]))
    ours = set(torch.isfinite(kept[0]).nonzero().flatten().tolist())
    assert ours == jax_support
    # kept entries are unchanged, the rest -inf
    np.testing.assert_array_equal(kept[0, sorted(ours)].numpy(),
                                  logits[sorted(ours)])
    # and the port's sampler draws inside it
    got = sampler._sample(torch.from_numpy(batch[:500]), list(range(500)),
                          [0] * 500, [1.0] * 500, [top_k] * 500,
                          [top_p] * 500)
    assert set(got) <= ours


def _tv(counts: np.ndarray, probs: np.ndarray) -> float:
    return 0.5 * float(np.abs(counts / counts.sum() - probs).sum())


def test_temperature_sampling_distribution():
    logits = np.asarray([1.5, 0.2, -0.3, 0.9, -1.0, 0.0, 0.4, -2.0],
                        np.float32)
    temp = 0.7
    probs = np.exp(logits / temp) / np.exp(logits / temp).sum()
    batch = np.tile(logits, (N_DRAWS, 1))
    ours = sampler._sample(torch.from_numpy(batch), list(range(N_DRAWS)),
                           [0] * N_DRAWS, [temp] * N_DRAWS)
    keys = jsampler._row_keys(jnp.arange(N_DRAWS, dtype=jnp.uint32),
                              jnp.zeros(N_DRAWS, jnp.int32))
    theirs = np.asarray(jsampler._sample(jnp.asarray(batch), keys,
                                         [temp] * N_DRAWS))
    assert _tv(np.bincount(ours, minlength=8), probs) < 0.05
    assert _tv(np.bincount(theirs, minlength=8), probs) < 0.05


def test_draws_depend_on_seed_and_draw_index_only():
    rng = np.random.default_rng(2)
    row = rng.normal(size=(1, 64)).astype(np.float32)
    other = rng.normal(size=(3, 64)).astype(np.float32)
    alone = sampler._sample(torch.from_numpy(row), [77], [5], [1.0])[0]
    batch = torch.from_numpy(np.concatenate([other, row]))
    placed = sampler._sample(batch, [1, 2, 3, 77], [0, 0, 0, 5],
                             [1.0] * 4)[3]
    assert alone == placed


def test_penalties_and_bias_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 40)).astype(np.float32)
    counts = rng.integers(0, 3, size=(3, 40)).astype(np.int32)
    pres = np.asarray([0.5, 0.0, -1.0], np.float32)
    freq = np.asarray([0.25, 1.0, 0.0], np.float32)
    ref = jsampler._apply_penalties(jnp.asarray(logits), jnp.asarray(counts),
                                    jnp.asarray(pres), jnp.asarray(freq))
    out = sampler._apply_penalties(torch.from_numpy(logits),
                                   torch.from_numpy(counts),
                                   torch.from_numpy(pres),
                                   torch.from_numpy(freq))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    bias = {3: 5.0, 7: -100.0}
    np.testing.assert_array_equal(sampler._bias_row(bias, 40),
                                  jsampler._bias_row(bias, 40))
