"""The MoE family against the reference: ``models/moe.py`` block by block,
and reduced olmoe-1b-7b (attn_full + MoE, MHA) as a model.

- ``moe_block`` at reduced olmoe's and deepseek-v2's shapes, and at the
  full configs' capacity factor 1.25, where experts overflow and entries
  drop: expert ids equal wherever the k-th and (k+1)-th probabilities
  differ by more than 1e-6 (torch.topk and lax.top_k order ties
  differently), dispatch entries and drop masks equal, y within Y_BAR of
  it and the aux loss within 1e-6; token groups lowered until they divide
  T.  Y_BAR is 1e-5, or 8 f32 ulps of the output's largest magnitude
  where that is more: the reference draws an (E, rows, cols) expert leaf
  with std E**-0.5 (its ``dense_init`` takes the first dim as the fan-in),
  so outputs reach ~50 at the reduced shapes, where one f32 ulp is 3.8e-6
  and the two frameworks' sums of the same products differ by 3 ulps.
- The router stays f32 under bf16 weights, and ``params_from_jax`` keeps
  it so.
- Reduced olmoe from the reference's weights: prefill, 48 ragged decode
  steps and an Engine stream with waves (tests/_torch_families.py).
- The combine is deterministic: two runs give the same bits.

f32 throughout but the bf16 router check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
import _torch_families as FAM
from repro.configs import get_reduced
from repro.models import lm as R_lm
from repro.models import moe as R_moe
from repro_torch.models import lm as P_lm
from repro_torch.models import moe as P_moe
from repro_torch.weights import params_from_jax

ARCHS = ("olmoe-1b-7b", "deepseek-v2-236b")


def y_bar(y):
    top = float(np.abs(y).max())
    return max(1e-5, 8 * 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 23))


def _block_params(cfg, seed, dtype=jnp.float32):
    rp = R_moe.init_moe_params(jax.random.key(seed), cfg.d_model,
                               cfg.n_experts, cfg.moe_d_ff,
                               cfg.n_shared_experts, cfg.activation, dtype)
    return rp, params_from_jax(jax.tree.map(np.asarray, rp), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf,n_groups", [(None, 0), (1.25, 0), (1.25, 3)],
                         ids=["reduced-cf", "cf1.25-drops", "cf1.25-groups"])
def test_moe_block_matches_reference(arch, cf, n_groups):
    """x (2, 40, d_model) through both blocks.  At cf 1.25 experts
    overflow, so entries drop; n_groups 3 is lowered to 2 (80 % 3 != 0)."""
    cfg = get_reduced(arch)
    cf = cfg.capacity_factor if cf is None else cf
    rp, pp = _block_params(cfg, 5)
    x = np.random.default_rng(6).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    kw = dict(top_k=cfg.top_k, capacity_factor=cf, n_groups=n_groups,
              activation=cfg.activation)
    ry, raux = R_moe.moe_block(rp, jnp.asarray(x), **kw)
    py, paux = P_moe.moe_block(pp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), rtol=0,
                               atol=y_bar(np.asarray(ry)))
    assert abs(float(paux) - float(raux)) <= 1e-6

    # the router's choice, and the dispatch of one group of 40 tokens
    E, k = cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax(jnp.asarray(x[0]) @ rp["router"], axis=-1)
    _, r_ids = jax.lax.top_k(probs, k)
    p_probs = torch.softmax(torch.from_numpy(x[0]) @ pp["router"], dim=-1)
    _, p_ids = torch.topk(p_probs, k, dim=-1)
    srt = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    clear = (srt[:, k - 1] - srt[:, k]) > 1e-6
    assert clear.all()           # no near-tie at this seed
    np.testing.assert_array_equal(p_ids.numpy()[clear],
                                  np.asarray(r_ids)[clear])
    G = x.shape[1]
    C = max(int(np.ceil(G * k / E * cf)), min(k, G))
    r_entry, r_valid = R_moe._dispatch_indices(r_ids, E, C)
    p_entry, p_valid = P_moe._dispatch_indices(
        torch.from_numpy(np.array(r_ids)).long(), E, C)
    np.testing.assert_array_equal(p_entry.numpy(), np.asarray(r_entry))
    np.testing.assert_array_equal(p_valid.numpy(), np.asarray(r_valid))
    if cf == 1.25:               # some expert overflowed: entries dropped
        assert int(p_valid.sum()) < G * k


def test_moe_combine_is_deterministic():
    cfg = get_reduced("olmoe-1b-7b")
    _, pp = _block_params(cfg, 7)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 33, cfg.d_model)).astype(np.float32))
    kw = dict(top_k=cfg.top_k, capacity_factor=1.25)
    a, _ = P_moe.moe_block(pp, x, **kw)
    b, _ = P_moe.moe_block(pp, x, **kw)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_router_stays_f32_under_bf16_weights():
    """The reference draws the router in f32 whatever the weights' dtype
    (moe.py:32); params_from_jax keeps it, and the port's init_lm does the
    same."""
    cfg = get_reduced("olmoe-1b-7b")
    rparams = R_lm.init_lm(cfg, jax.random.key(0), dtype=jnp.bfloat16)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    own = P_lm.init_lm(cfg, torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16, device="cpu")
    for tree in (pparams, own):
        m = tree["stage0"]["b0"]["mlp"]
        assert m["router"].dtype == torch.float32
        assert m["wi_gate"].dtype == m["wo"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pparams["stage0"]["b0"]["mlp"]["router"].numpy(),
        np.asarray(rparams["stage0"]["b0"]["mlp"]["router"]))


@pytest.fixture(scope="module")
def olmoe():
    cfg = get_reduced("olmoe-1b-7b")
    return (cfg,) + FAM.both_params(cfg, 2)


def test_olmoe_params_layout_matches(olmoe):
    cfg, rparams, pparams = olmoe
    own = P_lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        for tree in (pparams, own):
            node = tree
            for k in path:
                node = node[k.key]
            assert tuple(node.shape) == leaf.shape
            assert str(node.dtype) == f"torch.{leaf.dtype}"


def test_olmoe_prefill_and_ragged_decode_match(olmoe):
    FAM.prefill_and_ragged_decode(*olmoe)


def test_olmoe_engine_stream_with_waves_matches_reference(olmoe):
    FAM.engine_stream_with_waves(*olmoe)


def test_olmoe_forward_aux_matches_reference(olmoe):
    """``forward`` returns the summed MoE aux loss, as the reference's."""
    cfg, rparams, pparams = olmoe
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    rlog, raux, _ = R_lm.forward(cfg, rparams, jnp.asarray(toks))
    plog, paux, _ = P_lm.forward(cfg, pparams, torch.from_numpy(toks))
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), rtol=0,
                               atol=FAM.ATOL)
    assert abs(float(paux) - float(raux)) <= 1e-5
