"""The port's sharded prefill and decode against the JAX package's, on
gloo ranks on the CPU.

One `run_probe` a mesh, (data, model) = (1, 2) on 2 ranks and (2, 2) on
4, module-scoped: each rank converts the reference's smoke parameters in
f32 (`params_from_reference`), places them by `param_pspecs`, the
numpy-seeded prompt by `batch_pspecs`, and runs
`serving.engine.make_prefill_step` and then three `make_serve_step`
decode steps from its own prefill's caches, each fed the reference's
greedy token (teacher forcing). Rank 0 writes the gathered logits,
caches and tokens. The cases:

* the six family kinds: granite-3-2b (dense), deepseek-moe-16b (expert
  parallel, its capacity binding: C = ⌈T·K·0.75/E⌉ at the prefill),
  recurrentgemma-9b (RG-LRU channel parallel, its one kv head
  replicated), mamba2-1.3b (SSD head parallel), seamless-m4t-medium
  (the encoder's output placed as the batch) and internvl2-2b (its
  patches ahead of the prompt);
* granite-3-2b in the `long_500k` sliding-window form (a window of 16
  under a prompt of 32: the ring buffer), with a vocabulary of 500
  padded to 512, whose padded columns fall inside rank 1's block of the
  logits at a model axis of 2;
* recurrentgemma-9b with a batch of 1, as at `long_500k`'s B = 1: on
  (2, 2) it divides neither the data axis nor the model axis a conv
  window's batch is split over (`cache_pspecs`), so those are
  replicated; on (1, 2) it divides the data axis of one rank, which
  `rules.placements` then replicates too.

Each is held to the reference's `forward_prefill` and `forward_decode`
(decode jitted) on the same inputs: the prefill's last logits and every
cache leaf within 1e-5 · max|reference| and each leaf placed as
`cache_pspecs` places it; each decode step's logits within 1e-5 ·
max|reference| over the vocabulary (the padded columns the dtype's
lowest value) and its greedy token the reference's. Neither step makes
a DTensor (functional) all-gather, which crashes gloo ranks on CUDA
tensors on the card's PyTorch: the gathers are the ledger's. A decode
writes the attention cache it is given in place, at its slot and only
there, on one rank and sharded (`layers.attention_decode`).

About a minute here, the reference's side included.
"""
from __future__ import annotations

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke
from repro.models import Batch, forward_decode, forward_prefill, init_params
from repro.models.backbone import stack_plan
import repro_torch.configs as tconfigs
from repro_torch.models.layers import attention_decode, init_kv_cache
from repro_torch.substrate import run_probe
from repro_torch.tree import named_leaves

F32 = dict(compute_dtype="float32", param_dtype="float32")
TOL = 1e-5
S, STEPS, EXTRA = 32, 3, 8
CASES = {
    "granite-3-2b": ("granite-3-2b", {}, 4),
    "deepseek-moe-16b": ("deepseek-moe-16b",
                         {"moe": {"capacity_factor": 0.75}}, 4),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}, 4),
    "mamba2-1.3b": ("mamba2-1.3b", {}, 4),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}, 4),
    "internvl2-2b": ("internvl2-2b", {}, 4),
    "granite-3-2b-window": ("granite-3-2b", {"window": 16, "vocab": 500}, 4),
    "recurrentgemma-9b-batch1": ("recurrentgemma-9b", {}, 1),
}
MESHES = {"1x2": 2, "2x2": 4}

# one rank: every case of the spec on its mesh; rank 0 saves what it
# gathered
_RANK = r"""
import dataclasses, json, logging, pickle
import numpy as np
import torch
torch.set_num_threads(1)
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
from repro_torch.configs import get_config, smoke
from repro_torch.convert import params_from_reference
from repro_torch.launch.hlo import Counters
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Batch
from repro_torch.serving.engine import make_prefill_step, make_serve_step
from repro_torch.sharding.place import distribute_tree, full, full_tree
from repro_torch.sharding.rules import (
    batch_pspecs, cache_pspecs, param_pspecs, placements,
)
from repro_torch.substrate import init_from_env
from repro_torch.tree import named_leaves, tree_map

spec = json.load(open(@SPEC@))
rank, world = init_from_env()
mesh = make_host_mesh(2, device_type="cpu")
out = {}
for name in spec["run"]:
    arch, changes, n = spec["cases"][name]
    cfg = smoke(get_config(arch))
    changes = dict(changes)
    if "moe" in changes:
        changes["moe"] = dataclasses.replace(cfg.moe, **changes["moe"])
    cfg = cfg.replace(compute_dtype="float32", param_dtype="float32",
                      **changes)
    with open(f"{spec['dir']}/{name}.pkl", "rb") as f:
        ref = pickle.load(f)
    params = params_from_reference(ref["params"], cfg, "cpu")
    sp = distribute_tree(params, param_pspecs(params, mesh), mesh)
    fe = None if ref["frontend"] is None else torch.from_numpy(ref["frontend"])
    batch = Batch(tokens=torch.from_numpy(ref["tokens"][:, :spec["S"]]),
                  frontend=fe)
    sb = distribute_tree(batch, batch_pspecs(mesh, n, fe is not None), mesh)
    with Counters() as c:
        logits, caches = make_prefill_step(cfg, cache_len=ref["cache_len"])(
            sp, sb)
    want = named_leaves(cache_pspecs(mesh, caches, n))
    # copies: a replicated leaf's `full` is the rank's own tensor, which
    # the decode writes in place
    got = {"prefill": full(logits),
           "caches": tree_map(torch.clone, full_tree(caches)),
           "misplaced": [k for k, t in named_leaves(caches).items()
                         if tuple(t.placements)
                         != placements(want[k], mesh)],
           "ops": [c.ops()], "decode": [], "tokens": []}
    step = make_serve_step(cfg)
    for i, tok in enumerate(ref["feed"]):
        st = distribute_tree(torch.from_numpy(tok),
                             batch_pspecs(mesh, n).tokens, mesh)
        pos = ref["pos0"] + i
        before = None if i else type(caches["stack"][-1])(
            *(t.clone() for t in full_tree(caches["stack"][-1])))
        layer = caches["stack"][-1]
        with Counters() as c:
            nxt, logits, caches = step(sp, st, pos, caches)
        got["ops"].append(c.ops())
        got["decode"].append(full(logits))
        got["tokens"].append(full(nxt))
        if before is not None and hasattr(layer, "slot_pos"):
            # the cache given, written in place at its slot alone
            after = full_tree(layer)
            L = after.k.shape[1]
            slot = pos % L if cfg.window else pos
            rest = [j for j in range(L) if j != slot]
            got["in_place"] = {
                "same": caches["stack"][-1] is layer,
                "slot": bool(torch.equal(after.slot_pos[slot],
                                         torch.tensor(pos, dtype=torch.int32))),
                "written": [not torch.equal(a[:, slot], b[:, slot])
                            for a, b in ((after.k, before.k),
                                         (after.v, before.v))],
                "rest": all(torch.equal(a[:, rest], b[:, rest])
                            for a, b in ((after.k, before.k),
                                         (after.v, before.v)))
                and torch.equal(after.slot_pos[rest], before.slot_pos[rest])}
    out[name] = got
if rank == 0:
    torch.save(out, spec["out"])
"""


def _configs(arch, changes):
    """The reference's and the port's smoke `arch` in f32 with `changes`
    (a `moe` entry: a dict of the nested fields)."""
    import dataclasses
    out = []
    for c in (smoke(get_config(arch)),
              tconfigs.smoke(tconfigs.get_config(arch))):
        kw = dict(changes)
        if "moe" in kw:
            kw["moe"] = dataclasses.replace(c.moe, **kw["moe"])
        out.append(c.replace(**F32, **kw))
    return tuple(out)


def _reference_caches(caches, cfg) -> dict:
    """The reference's caches (the scanned groups' stacked as `p0`, ...)
    laid out as the port's lists of layers, as numpy arrays."""
    pat, n_groups, _ = stack_plan(cfg)

    def layer(c, g):
        return type(c)(*(np.array(a[g]) for a in c))

    stack = [layer(caches["stack"][f"p{i}"], g)
             for g in range(n_groups) for i in range(len(pat))]
    tail = [type(c)(*(np.array(a) for a in c)) for c in caches["tail"]]
    enc = caches["enc_out"]
    return {"stack": stack, "tail": tail,
            "enc_out": None if enc is None else np.array(enc)}


_jax_decode = jax.jit(forward_decode, static_argnums=(1,))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Each case's inputs, pickled for the ranks (the reference's
    parameters as numpy arrays, the prompt, the tokens fed), and the
    reference's prefill and decode outputs."""
    d = tmp_path_factory.mktemp("serve_sharded")
    want = {}
    for name, (arch, changes, n) in CASES.items():
        jc, _ = _configs(arch, changes)
        params = init_params(jax.random.PRNGKey(0), jc)
        rng = np.random.default_rng(3)
        toks = rng.integers(0, jc.vocab, (n, S)).astype(np.int32)
        fe = None if jc.frontend is None else (0.01 * rng.standard_normal(
            (n, jc.n_frontend_tokens, jc.d_model))).astype(np.float32)
        off = jc.n_frontend_tokens if jc.arch_type == "vlm" else 0
        cache_len = S + off + EXTRA
        logits, caches = forward_prefill(
            params, jc, Batch(tokens=jnp.asarray(toks),
                              frontend=None if fe is None
                              else jnp.asarray(fe)), cache_len=cache_len)
        got = {"prefill": np.array(logits),
               "caches": _reference_caches(caches, jc), "decode": [],
               "tokens": []}
        feed, tok = [], np.argmax(np.array(logits)[:, -1], -1)
        for i in range(STEPS):
            feed.append(tok[:, None].astype(np.int32))
            logits, caches = _jax_decode(params, jc, jnp.asarray(feed[-1]),
                                         jnp.asarray(S + off + i, jnp.int32),
                                         caches)
            tok = np.argmax(np.array(logits)[:, -1], -1)
            got["decode"].append(np.array(logits))
            got["tokens"].append(tok.astype(np.int32))
        with open(d / f"{name}.pkl", "wb") as f:
            pickle.dump({"params": jax.tree.map(np.array, params),
                         "tokens": toks, "frontend": fe, "feed": feed,
                         "pos0": S + off, "cache_len": cache_len}, f)
        want[name] = got
    return d, want


_RUNS: dict = {}


def _sharded(reference, mesh: str) -> dict:
    """Rank 0's outputs on `mesh`, every case, one probe a mesh."""
    if mesh not in _RUNS:
        d, _ = reference
        out = d / mesh
        out.mkdir(exist_ok=True)
        spec = out / "spec.json"
        spec.write_text(json.dumps({"cases": CASES, "run": list(CASES),
                                    "S": S, "dir": str(d),
                                    "out": str(out / "out.pt")}))
        run = run_probe(_RANK.replace("@SPEC@", repr(str(spec))),
                        world=MESHES[mesh], timeout=120, pg_timeout=60)
        # a failed run fails every test of its mesh, without a rerun
        _RUNS[mesh] = torch.load(out / "out.pt", weights_only=False) \
            if run.ok else run.report()
    got = _RUNS[mesh]
    assert isinstance(got, dict), got
    return got


def _close(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape),
                                            want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        assert np.array_equal(got.numpy(), want), what
        return
    err = float(np.max(np.abs(got.double().numpy() - want), initial=0.0))
    scale = float(np.max(np.abs(want), initial=0.0))
    assert err <= TOL * scale, f"{what}: {err} > {TOL} * {scale}"


PAIRS = [(c, m) for m in MESHES for c in CASES]


@pytest.mark.parametrize("case, mesh", PAIRS,
                         ids=[f"{c}-{m}" for c, m in PAIRS])
def test_prefill_matches_reference(reference, case, mesh):
    got = _sharded(reference, mesh)[case]
    want = reference[1][case]
    _close(got["prefill"], want["prefill"], f"{case} {mesh} prefill")
    assert got["misplaced"] == [], got["misplaced"]
    leaves = named_leaves(want["caches"])
    assert sorted(named_leaves(got["caches"])) == sorted(leaves)
    for leaf, t in named_leaves(got["caches"]).items():
        _close(t, leaves[leaf], f"{case} {mesh} cache {leaf}")


@pytest.mark.parametrize("case, mesh", PAIRS,
                         ids=[f"{c}-{m}" for c, m in PAIRS])
def test_decode_matches_reference(reference, case, mesh):
    got = _sharded(reference, mesh)[case]
    want = reference[1][case]
    vocab = _configs(*CASES[case][:2])[1].vocab
    for i in range(STEPS):
        logits = got["decode"][i]
        _close(logits[..., :vocab], want["decode"][i][..., :vocab],
               f"{case} {mesh} decode {i}")
        assert bool((logits[..., vocab:]
                     == torch.finfo(logits.dtype).min).all())
        assert np.array_equal(got["tokens"][i].numpy(), want["tokens"][i]), \
            (case, mesh, i)


@pytest.mark.parametrize("mesh", MESHES)
def test_steps_make_no_dtensor_all_gather(reference, mesh):
    """Every gather of both steps is the ledger's synchronous one
    (`c10d.*`); DTensor's own collectives are all-reduces alone."""
    for case, got in _sharded(reference, mesh).items():
        for ops in got["ops"]:
            functional = [op for op in ops if op.startswith(
                "_c10d_functional") and "all_reduce" not in op]
            assert not functional, (case, mesh, ops)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_decode_writes_its_cache_in_place(reference, mesh):
    """The last attention layer's cache (sequence split over `model`):
    the decode returns the cache it was given, with k and v written at
    the token's slot and nothing else changed."""
    for case in ("granite-3-2b", "granite-3-2b-window"):
        got = _sharded(reference, mesh)[case]["in_place"]
        assert got == {"same": True, "slot": True, "written": [True, True],
                       "rest": True}, (case, mesh, got)


@pytest.mark.parametrize("window", [0, 8], ids=["direct", "ring"])
def test_decode_writes_its_cache_in_place(window):
    """One rank: `attention_decode` writes k, v and `slot_pos` into the
    tensors of the cache it is given, at slot pos (pos % L in a ring)
    alone, and returns them; a second decode from the same prefill
    needs a copy of its own."""
    tc = _configs("granite-3-2b", {})[1]
    from repro_torch.models import init_params as t_init
    p = t_init(torch.Generator().manual_seed(0), tc)["layers"][0]["attn"]
    H, L, pos = tc.resolved_head_dim, 8, 11 if window else 5
    cache = init_kv_cache(2, L, tc.n_kv_heads, H, dtype=torch.float32,
                          device="cpu")
    cache.k.normal_(generator=torch.Generator().manual_seed(1))
    cache.v.normal_(generator=torch.Generator().manual_seed(2))
    cache.slot_pos.copy_(torch.arange(L, dtype=torch.int32)
                         + (8 if window else 0))
    before = [t.clone() for t in cache]
    x = torch.randn((2, 1, tc.d_model),
                    generator=torch.Generator().manual_seed(3))
    _, new = attention_decode(p, x, tc, position=pos, cache=cache,
                              window=window)
    assert all(a is b for a, b in zip(new, cache))
    slot = pos % L if window else pos
    rest = [j for j in range(L) if j != slot]
    for a, b in zip(cache[:2], before[:2]):
        assert not torch.equal(a[:, slot], b[:, slot])
        assert torch.equal(a[:, rest], b[:, rest])
    assert int(cache.slot_pos[slot]) == pos
    assert torch.equal(cache.slot_pos[rest], before[2][rest])
