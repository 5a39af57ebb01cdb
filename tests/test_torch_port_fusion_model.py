"""The port's fusion model against the JAX package, block by block and
whole: the same seeded numpy inputs through ``cervical_tpu.models`` on the
CPU and through ``cervical_tpu_torch.models``, with the JAX package's
initialised params carried over (``fusion_from_flax``, or the block's own
table below).

Limits: each block of ``models/layers.py`` and ``models/mae.py`` to 1e-5
absolute in f32 (the readings are 1e-7 to 2e-6: both sides round f32 sums
in another order), ``FusionMAE``'s outputs to 1e-4 (readings up to ~3e-6
at in_features 32, hidden 64).  ``pytest -s`` prints the readings.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cervical_tpu.data import masks as JM
from cervical_tpu.models import layers as JL
from cervical_tpu.models import mae as JMAE
from cervical_tpu.models.fusion import default_adjacency as j_default_adj
from cervical_tpu.ops import graph as JG
from cervical_tpu.train.torch_import import convert_fusion
from cervical_tpu_torch.data import masks as PM
from cervical_tpu_torch.models import layers as PL
from cervical_tpu_torch.models import mae as PMAE
from cervical_tpu_torch.models.fusion import DenseSAGEConv, FusionMAE
from cervical_tpu_torch.models.fusion import default_adjacency
from cervical_tpu_torch.ops import graph as PG
from cervical_tpu_torch.train.flax_import import (flatten_params,
                                                  fusion_from_flax,
                                                  fusion_to_flax, unflatten)

from torch_port_helpers import (fusion_feats, fusion_pair,
                                two_torch_threads)  # noqa: F401

MODS = ("imgN", "imgA", "imgL", "cli")
BLOCK_TOL, MODEL_TOL = 1e-5, 1e-4


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _err(a, b):
    return float(np.abs(_np(a).astype(np.float64) - _np(b)).max())


def _load(module, params, table):
    """Copy flax ``params`` into ``module`` by ``table``: (flax path, port
    name, kind), kinds as in ``flax_import._fusion_pairs``."""
    sd = {}
    for fp, tn, kind in table:
        node = params
        for p in fp:
            node = node[p]
        if kind == "norm":
            sd[tn + ".weight"] = node["scale"]
            sd[tn + ".bias"] = node["bias"]
        elif kind == "token":
            sd[tn] = np.asarray(node).reshape(1, 1, -1)
        else:
            sd[tn + ".weight"] = np.asarray(node["kernel"]).T
            if kind == "linear":
                sd[tn + ".bias"] = node["bias"]
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in sd.items()}, strict=True)
    return module


def _init(jmod, *args, seed=0, **kw):
    return jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(seed), *args, **kw)["params"])


def _vit_table(prefix, tprefix):
    p, t = prefix, tprefix
    return [(p + ("norm1",), t + "norm1", "norm"),
            (p + ("attn", "qkv"), t + "attn.qkv", "linear_nb"),
            (p + ("attn", "proj"), t + "attn.proj", "linear"),
            (p + ("norm2",), t + "norm2", "norm"),
            (p + ("mlp", "fc1"), t + "mlp.fc1", "linear"),
            (p + ("mlp", "fc2"), t + "mlp.fc2", "linear")]


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# -- ops/graph.py -------------------------------------------------------------

@pytest.mark.parametrize("rows,cols,diag", [(4, 4, True), (3, 5, False),
                                            (2, 2, True)])
def test_adjacencies_equal_jax(rows, cols, diag):
    np.testing.assert_array_equal(PG.grid_adjacency(rows, cols, diag),
                                  JG.grid_adjacency(rows, cols, diag))
    np.testing.assert_array_equal(PG.full_adjacency(rows),
                                  JG.full_adjacency(rows))
    a = PG.grid_adjacency(rows, cols, diag)
    np.testing.assert_array_equal(PG.mean_agg_matrix(a), JG.mean_agg_matrix(a))


def test_default_adjacency_equal_jax():
    for m, a in default_adjacency(MODS).items():
        np.testing.assert_array_equal(a, j_default_adj(MODS)[m])
    assert default_adjacency(MODS)["cli"].shape == (4, 4)
    np.testing.assert_allclose(default_adjacency(MODS)["cli"].sum(1), 1.0)


def test_sage_conv_and_dense_sage_conv():
    agg = PG.mean_agg_matrix(PG.grid_adjacency(4, 4))
    x = _rand((3, 16, 12), 1)
    wn, wr, b = _rand((12, 8), 2), _rand((12, 8), 3), _rand((8,), 4)
    ref = JG.sage_conv(jnp.asarray(x), jnp.asarray(agg), jnp.asarray(wn),
                       jnp.asarray(wr), jnp.asarray(b))
    got = PG.sage_conv(torch.from_numpy(x), agg, torch.from_numpy(wn),
                       torch.from_numpy(wr), torch.from_numpy(b))
    assert _err(ref, got) < BLOCK_TOL
    # the module form against JAX's DenseSAGEConv
    from cervical_tpu.models.fusion import DenseSAGEConv as JSage
    params = _init(JSage(8), jnp.asarray(x), jnp.asarray(agg))
    mod = _load(DenseSAGEConv(12, 8), params,
                [(("lin_l",), "lin_l", "linear"),
                 (("lin_r",), "lin_r", "linear_nb")])
    ref = JSage(8).apply({"params": params}, jnp.asarray(x), jnp.asarray(agg))
    got = mod(torch.from_numpy(x), torch.from_numpy(agg))
    print("DenseSAGEConv", _err(ref, got))
    assert _err(ref, got) < BLOCK_TOL


# -- models/layers.py ---------------------------------------------------------

@pytest.mark.parametrize("n,d", [(1, 8), (4, 64), (5, 7)])
def test_sinusoid_table_equal_jax(n, d):
    np.testing.assert_array_equal(PL.sinusoid_encoding_table(n, d),
                                  JL.sinusoid_encoding_table(n, d))


def test_drop_path_identity_at_rate_0_and_eval():
    x = torch.from_numpy(_rand((4, 3, 5), 5))
    assert PL.drop_path(x, 0.0, True) is x
    assert PL.drop_path(x, 0.3, False) is x
    y = PL.drop_path(x, 0.5, True, torch.Generator().manual_seed(0))
    kept = (y != 0).flatten(1).all(1)
    np.testing.assert_allclose(_np(y[kept]), _np(x[kept]) / 0.5, rtol=1e-6)


@pytest.mark.parametrize("shape", [(3, 16, 8), (4, 8), (2, 4, 8)])
def test_graph_norm_matches_jax(shape):
    """Graph-wide statistics with eps outside the square root; scale and
    bias drawn away from 1 / 0 so the affine counts."""
    x = _rand(shape, 6, 3.0) + 1.5
    jmod = JL.GraphNorm(8)
    params = {"scale": _rand((8,), 7) + 1.0, "bias": _rand((8,), 8)}
    mod = PL.GraphNorm(8)
    mod.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                         "bias": torch.from_numpy(params["bias"])})
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    got = mod(torch.from_numpy(x))
    print("GraphNorm", shape, _err(ref, got))
    assert _err(ref, got) < BLOCK_TOL
    # it is not a row LayerNorm on a multi-row sample
    if len(shape) == 3:
        ln = torch.nn.functional.layer_norm(torch.from_numpy(x), (8,))
        assert _err(got, ln * mod.weight + mod.bias) > 1e-3


def test_gated_attention_pool_matches_jax():
    x = _rand((3, 16, 64), 9)
    jmod = JL.GatedAttentionPool(64)
    params = _init(jmod, jnp.asarray(x))
    mod = _load(PL.GatedAttentionPool(64), params,
                [(("gate_fc1",), "gate_nn.0", "linear"),
                 (("gate_fc2",), "gate_nn.2", "linear")])
    rp, rg = jmod.apply({"params": params}, jnp.asarray(x))
    gp, gg = mod(torch.from_numpy(x))
    print("GatedAttentionPool", _err(rp, gp), _err(rg, gg))
    assert _err(rp, gp) < BLOCK_TOL and _err(rg, gg) < BLOCK_TOL
    np.testing.assert_allclose(_np(gg).sum(1), 1.0, atol=1e-6)


def test_mlp_matches_jax():
    x = _rand((3, 4, 64), 10)
    jmod = JL.Mlp(256, 64)
    params = _init(jmod, jnp.asarray(x))
    mod = _load(PL.Mlp(64, 256, 64).eval(), params,
                [(("fc1",), "fc1", "linear"), (("fc2",), "fc2", "linear")])
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    got = mod(torch.from_numpy(x))
    print("Mlp", _err(ref, got))
    assert _err(ref, got) < BLOCK_TOL


# dim 64 with 12 heads truncates like the reference's 512 / 12: head_dim 5,
# inner width 60 (qkv 64 -> 180, proj 60 -> 64)
@pytest.mark.parametrize("heads", [12, 8])
def test_vit_self_attention_matches_jax_with_key_mask(heads):
    x = _rand((3, 4, 64), 11)
    key_mask = np.array([[True, False, True, True],
                         [False, False, False, False],   # every key masked
                         [False, True, False, False]])
    jmod = JL.ViTSelfAttention(64, heads)
    params = _init(jmod, jnp.asarray(x))
    mod = _load(PL.ViTSelfAttention(64, heads).eval(), params,
                [(("qkv",), "qkv", "linear_nb"), (("proj",), "proj", "linear")])
    assert mod.qkv.weight.shape == (3 * (64 // heads) * heads, 64)
    for km in (None, key_mask):
        ref = jmod.apply({"params": params}, jnp.asarray(x),
                         key_mask=None if km is None else jnp.asarray(km))
        got = mod(torch.from_numpy(x),
                  None if km is None else torch.from_numpy(km))
        print("ViTSelfAttention", heads, km is not None, _err(ref, got))
        assert np.isfinite(_np(got)).all()
        assert _err(ref, got) < BLOCK_TOL


def test_fully_masked_row_attends_uniformly():
    """-1e9, not -inf: a row with every key masked gives JAX's uniform
    attention (the mean of the values), not NaN."""
    mod = PL.ViTSelfAttention(16, 2).eval()
    x = torch.from_numpy(_rand((1, 4, 16), 12))
    got = mod(x, torch.zeros((1, 4), dtype=torch.bool))
    qkv = mod.qkv(x).reshape(1, 4, 3, 2, 8)
    v = qkv[:, :, 2].reshape(1, 4, 16)
    ref = mod.proj(v.mean(1, keepdim=True).expand(1, 4, 16))
    assert _err(ref, got) < BLOCK_TOL


def test_vit_block_and_mixer_match_jax():
    x = _rand((3, 4, 64), 13)
    jmod = JL.ViTBlock(64, 12)
    params = _init(jmod, jnp.asarray(x))
    mod = _load(PL.ViTBlock(64, 12).eval(), params, _vit_table((), ""))
    km = np.array([[True, True, False, False]] * 3)
    ref = jmod.apply({"params": params}, jnp.asarray(x),
                     key_mask=jnp.asarray(km))
    got = mod(torch.from_numpy(x), torch.from_numpy(km))
    print("ViTBlock", _err(ref, got))
    assert _err(ref, got) < BLOCK_TOL

    jmix = JL.MixerBlock(4, 64)
    params = _init(jmix, jnp.asarray(x))
    params["norm"] = {"scale": _rand((64,), 14) + 1, "bias": _rand((64,), 15)}
    mix = _load(PL.MixerBlock(4, 64), params,
                [(("norm",), "norm", "norm"),
                 (("token_mix_fc1",), "mix_mip_1.0", "linear"),
                 (("token_mix_fc2",), "mix_mip_1.2", "linear"),
                 (("channel_mix_fc1",), "mix_mip_2.0", "linear"),
                 (("channel_mix_fc2",), "mix_mip_2.2", "linear")])
    ref = jmix.apply({"params": params}, jnp.asarray(x))
    got = mix(torch.from_numpy(x))
    print("MixerBlock", _err(ref, got))
    assert _err(ref, got) < BLOCK_TOL


# -- models/mae.py --------------------------------------------------------------

def _mae_table():
    t = [(("encoder", "patch_embed"), "encoder.patch_embed", "linear")]
    t += _vit_table(("encoder", "block0"), "encoder.blocks.0.")
    t += [(("encoder", "norm"), "encoder.norm", "norm"),
          (("encoder_to_decoder",), "encoder_to_decoder", "linear_nb"),
          (("mask_token",), "mask_token", "token")]
    t += _vit_table(("decoder", "block0"), "decoder.blocks.0.")
    t += [(("decoder", "norm"), "decoder.norm", "norm"),
          (("decoder", "head"), "decoder.head", "linear")]
    return t


def test_mae_encoder_decoder_match_jax():
    x = _rand((3, 4, 64), 16)
    vis = np.array([[True, False, False, False], [True] * 4,
                    [False, False, True, False]])
    jenc = JMAE.MAEEncoder(64)
    params = _init(jenc, jnp.asarray(x), jnp.asarray(vis))
    table = [(("patch_embed",), "patch_embed", "linear")] + _vit_table(
        ("block0",), "blocks.0.") + [(("norm",), "norm", "norm")]
    enc = _load(PMAE.MAEEncoder(64).eval(), params, table)
    ref = jenc.apply({"params": params}, jnp.asarray(x), jnp.asarray(vis))
    got = enc(torch.from_numpy(x), torch.from_numpy(vis))
    print("MAEEncoder", _err(ref, got))
    assert _err(ref, got) < BLOCK_TOL

    jdec = JMAE.MAEDecoder(64, 64)
    params = _init(jdec, jnp.asarray(x))
    table = _vit_table(("block0",), "blocks.0.") + [
        (("norm",), "norm", "norm"), (("head",), "head", "linear")]
    dec = _load(PMAE.MAEDecoder(64, 64).eval(), params, table)
    ref = jdec.apply({"params": params}, jnp.asarray(x))
    got = dec(torch.from_numpy(x))
    print("MAEDecoder", _err(ref, got))
    assert _err(ref, got) < BLOCK_TOL


@pytest.mark.parametrize("pattern", ["none", "train", "absent"])
def test_token_mae_matches_jax(pattern):
    x = _rand((4, 4, 64), 17)
    mask = {"none": np.zeros((4, 4), bool),
            "train": np.array(JM.generate_modal_masks(
                jax.random.PRNGKey(3), 4, 4)),
            "absent": np.array([[False, True, False, True]] * 4)}[pattern]
    jmae = JMAE.TokenMAE(64, 64)
    params = _init(jmae, jnp.asarray(x), jnp.asarray(mask))
    params["mask_token"] = _rand((64,), 18)  # away from its init scale
    mod = _load(PMAE.TokenMAE(64, 64).eval(), params, _mae_table())
    ref = jmae.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    got = mod(torch.from_numpy(x), torch.from_numpy(mask))
    print("TokenMAE", pattern, _err(ref, got))
    assert _err(ref, got) < BLOCK_TOL


# -- models/fusion.py -------------------------------------------------------------

_OUT_KEYS = ("one_x", "multi_x", "fea", "mae_out", "mae_labels")


def _compare(jm, params, pm, feats, present=None, mask=None):
    jo = jm.apply({"params": params}, {m: jnp.asarray(v)
                                       for m, v in feats.items()},
                  present=None if present is None else jnp.asarray(present),
                  mae_mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        po = pm({m: torch.tensor(v) for m, v in feats.items()},
                present=None if present is None else torch.tensor(present),
                mae_mask=None if mask is None else torch.tensor(mask))
    errs = {}
    for k in _OUT_KEYS:
        if jo[k] is None:
            assert po[k] is None, k
            continue
        errs[k] = _err(jo[k], po[k])
    for group in ("logits", "att1", "att2"):
        assert set(jo[group]) == set(po[group])
        for h in jo[group]:
            errs[f"{group}.{h}"] = _err(jo[group][h], po[group][h])
    return errs


@pytest.mark.parametrize("mods", [("imgN",), ("imgN", "cli"),
                                  ("imgN", "imgA", "imgL"), MODS])
def test_fusion_mae_outputs_match_jax(mods):
    jm, params, pm = fusion_pair(mods, seed=1)
    feats = fusion_feats(mods, 3, 2)
    errs = _compare(jm, params, pm, feats)
    print("FusionMAE", mods, max(errs.values()))
    assert max(errs.values()) < MODEL_TOL, errs
    if len(mods) > 1:
        # training-style masks: T-1 hidden per row
        mask = np.asarray(JM.generate_modal_masks(jax.random.PRNGKey(4), 3,
                                                  len(mods)))
        errs = _compare(jm, params, pm, feats, mask=mask)
        assert max(errs.values()) < MODEL_TOL, errs


def test_fusion_mae_every_present_pattern_matches_jax():
    """All 15 non-empty presence patterns of the 4-modal model (plus the
    empty one), absent slots zeroed and imputed as the predictor does."""
    jm, params, pm = fusion_pair(MODS, seed=5)
    feats = fusion_feats(MODS, 2, 6)
    worst = 0.0
    for bits in itertools.product([False, True], repeat=4):
        present = np.array([bits] * 2)
        f = {m: feats[m] * float(bits[i]) for i, m in enumerate(MODS)}
        mask = np.asarray(JM.imputation_masks(jnp.asarray(present)))
        errs = _compare(jm, params, pm, f, present, mask)
        worst = max(worst, max(errs.values()))
        assert max(errs.values()) < MODEL_TOL, (bits, errs)
    print("FusionMAE present patterns", worst)


def test_fusion_mae_without_mixer_matches_jax():
    jm, params, pm = fusion_pair(MODS, seed=7, mix=False)
    assert not hasattr(pm, "mix") and "mixer" not in params
    errs = _compare(jm, params, pm, fusion_feats(MODS, 2, 8))
    assert max(errs.values()) < MODEL_TOL, errs


def test_train_mode_dropout_changes_output_and_repeats():
    _, _, pm = fusion_pair(MODS, seed=9)
    feats = {m: torch.from_numpy(v) for m, v in
             fusion_feats(MODS, 3, 10).items()}
    mask = torch.tensor(np.asarray(JM.generate_modal_masks(
        jax.random.PRNGKey(1), 3, 4)))
    with torch.no_grad():
        ev = pm(feats, mae_mask=mask)["logits"]["all"]
        pm.train()
        a = pm(feats, mae_mask=mask)["logits"]["all"]
        b = pm(feats, mae_mask=mask)["logits"]["all"]
    assert not torch.allclose(a, ev) and not torch.equal(a, b)
    _, _, pm2 = fusion_pair(MODS, seed=9)
    with torch.no_grad():
        pm2.train()
        a2 = pm2(feats, mae_mask=mask)["logits"]["all"]
    assert torch.equal(a, a2)  # seeded dropout generators repeat


def test_batch_independence():
    _, _, pm = fusion_pair(("imgN", "cli"), seed=11)
    feats = {m: torch.from_numpy(v) for m, v in
             fusion_feats(("imgN", "cli"), 3, 12).items()}
    with torch.no_grad():
        full = pm(feats)["logits"]["all"]
        for i in range(3):
            one = pm({m: v[i:i + 1] for m, v in feats.items()})
            assert _err(full[i], one["logits"]["all"][0]) < 1e-5


def test_in_features_checked():
    _, _, pm = fusion_pair(("imgN", "cli"), seed=0)
    with pytest.raises(ValueError, match="in_features"):
        pm({m: torch.zeros(1, 16 if m == "imgN" else 4, 7)
            for m in ("imgN", "cli")})


# -- weights carried across -------------------------------------------------------

@pytest.mark.parametrize("mods", [("imgN",), ("imgN", "cli"), MODS])
def test_convert_fusion_of_port_state_dict_equals_flax_params(mods):
    _, params, pm = fusion_pair(mods, seed=13)
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    conv, stats, missing = convert_fusion(sd, mods, strict=True)
    assert not missing and not stats
    a, b = flatten_params(conv), flatten_params(params)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # every port tensor is read by convert_fusion: the names are the
    # reference's
    assert len(a) == len(sd)
    back = flatten_params(fusion_to_flax(pm.state_dict()))
    assert set(back) == set(b)
    for k in back:
        np.testing.assert_array_equal(back[k], b[k], err_msg=k)


def test_flatten_unflatten_round_trip():
    _, params, _ = fusion_pair(MODS, seed=14)
    flat = flatten_params(params)
    from flax import traverse_util
    ref = traverse_util.flatten_dict(params, sep="/")
    assert set(flat) == set(ref)
    back = unflatten(flat)
    sd = fusion_from_flax(back)
    sd2 = fusion_from_flax(params)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd2)


def test_reference_state_dict_loads_dropping_dead_layers():
    """The reference model's state_dict carries the dead fc_cli_1/fc_cli_2
    layers (my_mae_model.py:421-422); the loader drops them and loads the
    rest strictly."""
    from cervical_tpu_torch.train.torch_import import load_fusion
    _, _, pm = fusion_pair(MODS, seed=15)
    sd = {k: v.clone() + 1.0 for k, v in pm.state_dict().items()}
    sd["fc_cli_1.weight"] = torch.zeros(3, 3)
    sd["fc_cli_2.bias"] = torch.zeros(3)
    target = FusionMAE(MODS, 32, 64)
    dropped = load_fusion(target, sd)
    assert sorted(dropped) == ["fc_cli_1.weight", "fc_cli_2.bias"]
    for k, v in target.state_dict().items():
        assert torch.equal(v, sd[k])
    sd["unexpected.weight"] = torch.zeros(1)
    with pytest.raises(RuntimeError):
        load_fusion(target, sd)


def test_init_follows_the_jax_initialisers():
    """lecun-normal kernels (std sqrt(1/fan_in), |w| <= 2 sigma), zero
    biases, xavier-uniform inside the MAE, norms at 1 / 0, the mask token
    within +-0.02; drawn from the generator alone."""
    pm = FusionMAE(MODS, 256, 512).init_weights(torch.Generator().manual_seed(0))
    pm.requires_grad_(False)
    w = pm.imgN_gnn_2.lin_l.weight
    std = (1 / 256) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(pm.imgN_gnn_2.lin_l.bias.abs().max()) == 0.0
    q = pm.mae.encoder.blocks[0].attn.qkv.weight
    limit = (6 / (q.shape[0] + q.shape[1])) ** 0.5
    assert float(q.abs().max()) <= limit and float(q.abs().max()) > 0.9 * limit
    assert float(pm.mae.mask_token.abs().max()) <= 0.02
    assert float(pm.mae.mask_token.std()) > 0.005
    assert torch.equal(pm.mix.norm.weight, torch.ones(512))
    pm2 = FusionMAE(MODS, 256, 512).init_weights(
        torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(pm.state_dict().values(), pm2.state_dict().values()))


# -- data/masks.py ----------------------------------------------------------------

@pytest.mark.parametrize("t,k", [(4, None), (4, 1), (3, 2), (2, None)])
def test_generate_modal_masks_counts_and_uniformity(t, k):
    g = torch.Generator().manual_seed(0)
    m = PM.generate_modal_masks(g, 4000, t, k)
    k = t - 1 if k is None else k
    assert m.dtype == torch.bool and m.shape == (4000, t)
    assert bool((m.sum(1) == k).all())
    # each slot masked with probability k/t (JAX's permutation of a prefix)
    share = m.float().mean(0).numpy()
    np.testing.assert_allclose(share, k / t, atol=0.03)
    jm = np.asarray(JM.generate_modal_masks(jax.random.PRNGKey(0), 64, t, k))
    assert (jm.sum(1) == k).all()
    with pytest.raises(ValueError):
        PM.generate_modal_masks(g, 2, t, t)


def test_imputation_masks_equal_jax():
    present = np.array(list(itertools.product([False, True], repeat=4)))
    ref = np.asarray(JM.imputation_masks(jnp.asarray(present)))
    got = PM.imputation_masks(torch.from_numpy(present)).numpy()
    np.testing.assert_array_equal(got, ref)
