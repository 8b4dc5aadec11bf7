"""The port's MoE layer (`repro_torch.models.moe`) and its all-to-all
dispatch (`moe_shard_map`) against the JAX package, on the CPU.

The smoke MoE configurations in float32 (qwen3-moe-30b-a3b: 4 experts,
top-2, no shared expert; deepseek-moe-16b: one shared expert), the
reference's `init_moe_params` carried across, inputs made with numpy
from a seed:

* `moe_apply` against the reference's: output within 1e-5 · max|out|,
  the aux and z losses within 1e-5 relative, the drop fraction exactly,
  at a capacity that drops nothing and at capacities that drop (slots
  kept in the flattened (token, k) order);
* router ties: tied probabilities keep the lower expert first, as
  `lax.top_k` does, and a batch of repeated tokens fills the slots in
  token order;
* twins of the reference's `tests/test_model_properties.py` MoE cases
  (every token routed or dropped, permutation equivariance);
* `moe_apply_a2a` on 4 gloo ranks (`run_probe`, a 2 x 2 data x model
  mesh): each rank's tokens within 1e-5 · max|.| of `moe_apply` on the
  whole batch, with one `all_to_all_experts` out and one back (the
  ledger and the wrapped `torch.distributed` calls) and no all-reduce
  — the reference's `tests/test_moe_a2a.py` on the port.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke
from repro.models.moe import init_moe_params as jax_init_moe_params
from repro.models.moe import moe_apply as jax_moe_apply
import repro_torch.configs as tconfigs
from repro_torch.convert import from_reference
from repro_torch.models.moe import moe_apply, moe_sharding, route
from repro_torch.sharding.rules import P
from repro_torch.substrate import run_probe

F32 = dict(compute_dtype="float32", param_dtype="float32")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(arch="qwen3-moe-30b-a3b", cf=8.0):
    jc = smoke(get_config(arch)).replace(**F32)
    tc = tconfigs.smoke(tconfigs.get_config(arch)).replace(**F32)
    jc = jc.replace(moe=dataclasses.replace(jc.moe, capacity_factor=cf))
    tc = tc.replace(moe=dataclasses.replace(tc.moe, capacity_factor=cf))
    return jc, tc


def _params(jc, seed=0):
    p = jax_init_moe_params(jax.random.PRNGKey(seed), jc, jnp.float32)
    return p, _to_port(p)


def _to_port(p):
    if isinstance(p, dict):
        return {k: _to_port(v) for k, v in p.items()}
    return from_reference(p, "cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check(jp, tp, jc, tc, x):
    want, jaux = jax_moe_apply(jp, jnp.asarray(x), jc)
    got, aux = moe_apply(tp, torch.from_numpy(x), tc)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got.numpy() - want)))
    assert err <= TOL * float(np.max(np.abs(want))), err
    for k in ("moe_aux_loss", "moe_z_loss"):
        assert abs(float(aux[k]) - float(jaux[k])) <= \
            TOL * abs(float(jaux[k])), k
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
    return got, aux


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-moe-16b"])
@pytest.mark.parametrize("cf", [8.0, 1.0, 0.25])
def test_moe_apply_matches_reference(arch, cf):
    jc, tc = _cfgs(arch, cf)
    jp, tp = _params(jc)
    _, aux = _check(jp, tp, jc, tc, _x(1, (2, 16, jc.d_model)))
    assert (float(aux["moe_drop_frac"]) == 0.0) == (cf == 8.0)


def test_moe_decode_capacity_of_one_matches_reference():
    """Decode's shape: a few tokens, C = 1, which token keeps an expert
    decided by the slot order alone."""
    jc, tc = _cfgs(cf=1.25)
    jp, tp = _params(jc, 3)
    _check(jp, tp, jc, tc, _x(4, (3, 1, jc.d_model)))


def test_router_ties_keep_the_lower_expert_first():
    """Duplicate router columns tie two experts' probabilities exactly:
    the port picks as `lax.top_k` does, and a batch of one token
    repeated fills the slots in token order (capacity drops the rest)."""
    jc, tc = _cfgs(cf=0.5)
    jp, _ = _params(jc, 5)
    router = np.array(jp["router"])
    router[:, 3] = router[:, 1]
    router[:, 2] = router[:, 0]
    jp = {**jp, "router": jnp.asarray(router)}
    tp = _to_port(jp)
    x = _x(6, (1, 12, jc.d_model))
    x[0, 6:] = x[0, :6]                          # repeated tokens
    logits = x.reshape(-1, jc.d_model) @ router
    _, _, top_e = route(torch.from_numpy(logits), 2)
    _, want_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), 2)
    assert np.array_equal(top_e.numpy(), np.asarray(want_e))
    _, aux = _check(jp, tp, jc, tc, x)
    assert float(aux["moe_drop_frac"]) > 0.0


def test_moe_every_token_routed_or_dropped_consistently():
    jc, tc = _cfgs()
    _, tp = _params(jc)
    x = torch.from_numpy(_x(3, (2, 16, tc.d_model)))
    out, aux = moe_apply(tp, x, tc)
    assert out.shape == x.shape
    assert float(aux["moe_drop_frac"]) == 0.0          # high capacity
    assert float(aux["moe_aux_loss"]) > 0.0
    tc2 = tc.replace(moe=dataclasses.replace(tc.moe, capacity_factor=0.1))
    _, aux2 = moe_apply(tp, x, tc2)
    assert float(aux2["moe_drop_frac"]) > 0.0


def test_moe_permutation_equivariance():
    """Permuting tokens permutes outputs (routing is per-token)."""
    jc, tc = _cfgs()
    _, tp = _params(jc)
    x = torch.from_numpy(_x(4, (1, 12, tc.d_model)))
    out, _ = moe_apply(tp, x, tc)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(12))
    out_p, _ = moe_apply(tp, x[:, perm], tc)
    np.testing.assert_allclose(out[:, perm].numpy(), out_p.numpy(),
                               atol=1e-4)


def test_moe_sharding_takes_no_hint_and_refuses_one():
    """Unset hints change nothing, and neither do the reference's two
    (`launch/dryrun.py`'s: expert batches over `model`, tokens over the
    data axes), which are the layouts the sharded layer on DTensors
    always takes; any other spec raises, since torch has no sharding
    constraint to apply it with."""
    jc, tc = _cfgs()
    _, tp = _params(jc)
    x = torch.from_numpy(_x(7, (1, 8, tc.d_model)))
    out, _ = moe_apply(tp, x, tc)
    for eb, tok in ((None, None),
                    (P("model", None, None), P(("data",), None)),
                    (("model", None, None), P(("pod", "data"), None)),
                    (None, P("data", None))):
        with moe_sharding(expert_batch=eb, tokens=tok):
            inside, _ = moe_apply(tp, x, tc)
        assert torch.equal(out, inside)
    for eb, tok in ((P(None, "model", None), None),
                    (None, P(None, "data")),
                    (P("data", None, None), P("data", None))):
        with pytest.raises(ValueError, match="no other sharding constraint"):
            with moe_sharding(expert_batch=eb, tokens=tok):
                pass


# ---- the all-to-all dispatch on gloo ranks -----------------------------

_A2A = r"""
import dataclasses, json
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import obs
from repro_torch.configs import get_config, smoke
from repro_torch.models.moe import moe_apply
from repro_torch.models.moe_shard_map import moe_apply_a2a
from repro_torch.substrate import data_model_mesh, init_from_env
from repro_torch.testing import count_collectives

rank, world = init_from_env()
mesh = data_model_mesh(2)                  # (data, model) = divmod(rank, 2)
cfg = smoke(get_config({arch!r})).replace(compute_dtype="float32",
                                          param_dtype="float32")
cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
d = np.load({path!r})
full = {{"router": torch.from_numpy(d["router"]),
         "experts": {{k[2:]: torch.from_numpy(d[k]) for k in d.files
                     if k.startswith("e_")}}}}
if "s_w_up" in d.files:
    full["shared"] = {{k[2:]: torch.from_numpy(d[k]) for k in d.files
                      if k.startswith("s_")}}
x = torch.from_numpy(d["x"])
ref, _ = moe_apply(full, x, cfg)
dc, mc = mesh.get_coordinate()
E_loc = cfg.moe.n_experts // 2
mine = {{**full, "experts": {{k: v[mc * E_loc:(mc + 1) * E_loc].contiguous()
                             for k, v in full["experts"].items()}}}}
b_loc = x.shape[0] // 2
xb = x[dc * b_loc:(dc + 1) * b_loc].contiguous()
obs.reset()
with count_collectives() as calls:
    out, _ = moe_apply_a2a(mine, xb, cfg, mesh)
want = ref[dc * b_loc:(dc + 1) * b_loc]
print("RESULT " + json.dumps({{
    "err": float((out - want).abs().max()),
    "scale": float(want.abs().max()),
    "calls": dict(calls),
    "a2a": obs.counter_total("collective.calls", op="all_to_all_experts",
                             axis="model"),
    "bytes": obs.counter_total("collective.bytes", op="all_to_all_experts",
                               axis="model"),
    "others": obs.counter_total("collective.calls")}}))
"""


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-moe-16b"])
def test_moe_apply_a2a_matches_moe_apply_with_one_all_to_all_each_way(
        arch, tmp_path):
    jc, tc = _cfgs(arch)
    jp, _ = _params(jc, 7)
    arrays = {"router": np.array(jp["router"]),
              "x": _x(8, (4, 16, jc.d_model))}
    arrays.update({"e_" + k: np.array(v) for k, v in jp["experts"].items()})
    if "shared" in jp:
        arrays.update({"s_" + k: np.array(v)
                       for k, v in jp["shared"].items()})
    np.savez(tmp_path / "moe.npz", **arrays)
    run = run_probe(_A2A.format(arch=arch, path=str(tmp_path / "moe.npz")),
                    world=4, timeout=120, pg_timeout=60)
    assert run.ok, run.report()
    E, d = jc.moe.n_experts, jc.d_model
    C = int(np.ceil(2 * 16 * jc.moe.top_k * 8.0 / E))
    for r in run.ranks:
        line = [s for s in r.stdout.splitlines() if s.startswith("RESULT ")]
        res = json.loads(line[0][len("RESULT "):])
        assert res["err"] <= TOL * res["scale"], res
        assert res["calls"] == {"all_to_all_single": 2}
        assert res["a2a"] == res["others"] == 2
        assert res["bytes"] == 2 * 2 * E * C * d * 4
