"""On a mesh, the MoE dispatch on each rank's own tokens and experts and a
decode over a seq-split cache on each rank's own slots, against the
port's unsharded path and the JAX package's ``moe_forward``.

A gloo world of 4 CPU ranks and one of 1 are spawned once for the
module (``tests/_torch_dist_ranks.py:spawn_world``), every rank running
``tests/_torch_mesh_local_ranks.py:run_world``: the reduced deepseek and
phi3.5-moe MoE layer in f32 (at capacity factor 1.0, so every case drops
hits) on the (data, model) meshes (2, 2), (4, 1) and (1, 4) (and (1, 1)
in the world of 1), grouped (G = 4, 8) and plain;
then a prefill and a decode of the reduced qwen3 (GQA) and deepseek
(MLA) under ``kv_shard="seq"``.

Tolerances, stated once:

* the routed experts' output, aux and the gradient of x: bitwise the
  unsharded port's on every mesh (each hit row is filled on one ``model``
  rank and summed exactly; the CPU's ``bmm`` over ``E/n`` experts gives
  each expert's product bit for bit as over ``E``);
* the experts' and the router's gradients: bitwise where ``data`` is 1;
  over several data ranks within ``GRAD_TOL`` of each leaf's max|g| (each
  rank sums its own tokens' share, the ranks' shares are then summed: the
  same sum in another order);
* deepseek's whole layer (its shared experts a dense MLP split over
  ``model``, its output's partial sums reduced over the axis in another
  order than one product's): within ``GRAD_TOL`` of max|y| and of each
  leaf's max|g|, bitwise where ``model`` is 1 (the output, x's gradient);
* the port's unsharded path against JAX's ``moe_forward`` without a
  mesh: ``EP_TOL`` of max|y| and of each leaf's max|g| (f32 products in
  another order);
* the seq-split decode's logits: within ``SERVE_RTOL`` of the unsharded
  port's (the ranks' partial softmaxes merged by their log-sum-exp);
  bitwise on one rank (a single partial passes the merge unchanged).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as dist_ranks
import _torch_mesh_local_ranks as ranks
from repro.configs import base as jbase
from repro.models import moe as jmoe
from repro_torch.configs.base import get_reduced
from repro_torch.models import moe

GROUP_TIMEOUT_S = 120.0
GRAD_TOL = 1e-6
EP_TOL = 1e-5
SERVE_RTOL = 1e-5
WORLD_MESHES = ((4, ranks.MESHES), (1, ((1, 1),)))
CASES = [(dm, arch, variant, g) for _, meshes in WORLD_MESHES for dm in meshes
         for arch in ranks.MOE_ARCHS
         for variant in (("routed", "layer") if arch.startswith("deepseek") else ("routed",))
         for g in ranks.GROUPS]


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """Every rank's outputs, by world."""
    root = tmp_path_factory.mktemp("mesh_local")
    got = {}
    for world, _ in WORLD_MESHES:
        dist_ranks.spawn_world(ranks.run_world, world, (str(root),), str(root / f"rdv{world}"),
                               GROUP_TIMEOUT_S)
        got[world] = [dict(np.load(root / f"w{world}_r{r}.npz")) for r in range(world)]
    return got


def _id(case):
    dm, arch, variant, g = case
    return f"{ranks.mesh_tag(dm)}-{arch.split('-')[0]}-{variant}-g{g}"


def _world(dm):
    return 1 if dm == (1, 1) else 4


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_moe_on_mesh_is_the_unsharded_port(out, case):
    """Output, aux and every gradient against the unsharded port on the
    same weights and batch (module note for which are bitwise)."""
    dm, arch, variant, g = case
    o, ref = out[_world(dm)][0], out[4][0]
    key = f"{arch}.{variant}.g{g}"
    got = {k[len(f"{ranks.mesh_tag(dm)}.{key}."):]: v for k, v in o.items()
           if k.startswith(f"{ranks.mesh_tag(dm)}.{key}.") and not k.endswith(".calls")}
    want = {k[len(f"plain.{key}."):]: v for k, v in ref.items()
            if k.startswith(f"plain.{key}.")}
    assert set(got) == set(want) and "grad/w_down" in want
    exact = variant == "routed" or dm[1] == 1
    for k in ("y", "grad.x"):
        if exact:
            assert np.array_equal(got[k], want[k]), k
        else:
            assert _rel(got[k], want[k]) <= GRAD_TOL, (k, _rel(got[k], want[k]))
    assert np.array_equal(got["aux"], want["aux"])
    for k in want:
        if k.startswith("grad/"):
            if dm[0] == 1 and exact:
                assert np.array_equal(got[k], want[k]), k
            else:
                assert _rel(got[k], want[k]) <= GRAD_TOL, (k, _rel(got[k], want[k]))


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == "routed"],
                         ids=[_id(c) for c in CASES if c[2] == "routed"])
def test_each_rank_dispatches_its_own_tokens_and_experts(out, case):
    """Each rank's dispatch calls: grouped, its ``G / n_data`` groups of
    ``n/G`` tokens routed and emitted, ``E / n_model`` experts, capacity
    ``capacity_of(n/G)``; plain, the whole call routed (capacity from all
    ``n``) and its own ``n / n_data`` tokens emitted."""
    dm, arch, _, g = case
    m = ranks.moe_cfg(arch, g).moe
    n = ranks.B * ranks.S
    e = m.n_experts // dm[1]
    for o in out[_world(dm)]:
        calls = o[f"{ranks.mesh_tag(dm)}.{arch}.routed.g{g}.calls"].tolist()
        if g:
            want = [[n // g, n // g, e, moe.capacity_of(n // g, m)]] * (g // dm[0])
        else:
            want = [[n // dm[0], n, e, moe.capacity_of(n, m)]]
        assert calls == want


def test_groups_not_a_multiple_of_the_batch_ranks_raise(out):
    o = out[4][0]
    assert str(o["refuse.g2"]) == ("dispatch_groups=2 over a batch of 4 rows do not split "
                                   "over 4 batch ranks")
    assert str(o["refuse.g3"]) == "128 tokens do not split into dispatch_groups=3"


def _jax_moe(arch, groups, shared):
    """JAX's ``moe_forward`` without a mesh on the same weights and batch:
    y, aux and the gradients of sum(y · cot) + aux."""
    jcfg = ranks.moe_cfg(arch, groups, jbase.get_reduced(arch))
    p = jax.tree.map(lambda t: jnp.asarray(t.numpy()), ranks.moe_params(arch, shared))
    x, cot = ranks.moe_inputs(arch)

    def loss(p, x):
        y, aux = jmoe.moe_forward(p, x, jcfg)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        p, jnp.asarray(x))
    got = {"y": np.asarray(y), "aux": np.asarray(aux), "grad.x": np.asarray(gx)}
    got.update({f"grad{k}": np.asarray(v) for k, v in ranks._flat(gp).items()})
    return got


@pytest.mark.parametrize("arch", ranks.MOE_ARCHS)
@pytest.mark.parametrize("g", ranks.GROUPS)
def test_unsharded_port_is_jax(out, arch, g):
    """The reference the mesh runs are held to, against JAX's
    ``moe_forward`` without a mesh (whole layer: deepseek's shared experts
    included)."""
    variant = "layer" if arch.startswith("deepseek") else "routed"
    want = _jax_moe(arch, g, variant == "layer")
    ref = out[4][0]
    for k, w in want.items():
        got = ref[f"plain.{arch}.{variant}.g{g}.{k}"]
        if k == "aux":
            np.testing.assert_allclose(got, w, rtol=1e-6)
        else:
            assert _rel(got, w) <= EP_TOL, (k, _rel(got, w))


@pytest.mark.parametrize("arch", ranks.MOE_ARCHS)
@pytest.mark.parametrize("g", ranks.GROUPS)
def test_the_cases_drop_hits(arch, g):
    """Some hit overflows its expert's capacity in every grouped and plain
    case, so the exactness above covers dropped hits."""
    m = ranks.moe_cfg(arch, g).moe
    x, _ = ranks.moe_inputs(arch)
    w = ranks.moe_params(arch)["w_router"]
    xf = torch.from_numpy(x).reshape(-1, x.shape[-1])
    n = xf.shape[0] // g if g else xf.shape[0]
    dropped = 0
    for xg in xf.split(n):
        _, experts, _, _ = moe._route(xg, w, m.top_k)
        counts = torch.bincount(experts.reshape(-1), minlength=m.n_experts)
        dropped += int((counts - moe.capacity_of(n, m)).clamp_min(0).sum())
    assert dropped > 0


@pytest.mark.parametrize("dm", [*ranks.SERVE_MESHES, (1, 1)], ids=ranks.mesh_tag)
@pytest.mark.parametrize("arch", ranks.SERVE_ARCHS)
def test_seq_split_decode_matches_the_unsharded_port(out, dm, arch):
    """A prefill and one decode with every cache leaf's slots split over
    ``model``: the logits within ``SERVE_RTOL`` of the unsharded port's
    (bitwise on one rank), and no all-gather of the decode has a cache
    leaf's local shape."""
    o = out[_world(dm)][0]
    k = f"serve.{ranks.mesh_tag(dm)}.{arch}"
    got, want = o[f"{k}.logits"], out[4][0][f"serve.none.{arch}.logits"]
    assert got.shape == want.shape == (ranks.B, 2, get_reduced(arch).vocab)
    assert bool(o[f"{k}.split"]) and not bool(o[f"{k}.gathered_cache"])
    if dm == (1, 1):
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=SERVE_RTOL,
                                   atol=SERVE_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ranks.SERVE_ARCHS)
def test_decode_length_cuts_a_rank_and_leaves_one_empty(out, arch):
    """On (1, 4) each rank holds 8 slots; the decode's length (PROMPT + 1
    = 19) leaves ranks 0 and 1 whole, cuts rank 2's to 3 and leaves rank 3
    none: each rank attends to those alone, every layer alike."""
    per = ranks.SLOTS // 4
    got = [o[f"serve.1x4.{arch}.slots"].tolist() for o in out[4]]
    want = [[min(max(ranks.PROMPT + 1 - r * per, 0), per)] for r in range(4)]
    assert want == [[8], [8], [3], [0]] and got == want
