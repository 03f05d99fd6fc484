"""The port's CUDA kernels on the card, against their plain PyTorch versions.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card.  The file imports neither JAX nor the JAX package,
so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Quantized mode is held bitwise; float mode to ``atol = rtol = 1e-4`` (the
kernel sums each row in its own fixed order, the plain version through
``torch.matmul``).  The training kernels' ``dw`` goes through ``exp`` and
sums in another order than the plain version's products, so it is held to
``max |Δdw| <= DW_TOL * max |dw|`` per matrix in both modes; their
``acc_y``, ``n_spk`` and traces (``rsnn_forward``'s seven streams, and the
``h, xbar, pbar, zbar`` that ``rsnn_train`` returns on request) are bitwise when
quantized; ``rsnn_train``'s readout error goes through ``expf`` and is held
to ``ERR_TOL`` when quantized, ``FLOAT_TOL`` in float mode.  The flash-attention kernel is held to its plain version at
``FLASH_F32_TOL`` relative to ``max |o|`` in f32, and in bf16 per query row
at ``BF16_ROW_TOL`` of the row's ``max |o|`` (``row_error`` and its
justification are in ``repro_torch/kernels/flash_attention.py``); its
backward at ``FLASH_F32_TOL`` of each gradient's max|.| in f32 (a gradient
that is zero in theory against the largest of the three) and in bf16
per row at ``BWD_BF16_ROW_TOL`` (``grad_row_error``, the same module).  A
bf16 LM train step through the kernels is held to the same step through
the plain versions per gradient leaf at ``LM_GRAD_TOL`` of the leaf's
max|g|.
"""

import numpy as np
import pytest
import torch

import dataclasses

from repro_torch.core.aer import encode_sample
from repro_torch.core.backend import ExecutionBackend
from repro_torch.core.rsnn import Presets
from repro_torch.kernels import eprop_update, ops, rsnn_step
from repro_torch.serve import BatchedEngine

FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)
DW_TOL = 1e-4
ERR_TOL = dict(atol=1e-6, rtol=0)
FLASH_F32_TOL = 1e-5


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's products
    return torch.device("cuda", 0)


def _params(rng, cfg, gain=2.5):
    shapes = {"w_in": (cfg.n_in, cfg.n_hid), "w_rec": (cfg.n_hid, cfg.n_hid),
              "w_out": (cfg.n_hid, cfg.n_out)}
    p = {k: torch.from_numpy((gain * rng.normal(size=s) / np.sqrt(s[0]))
                             .astype(np.float32)) for k, s in shapes.items()}
    p["alpha"] = torch.tensor(cfg.neuron.alpha)
    return p


def _check(a, b, quantized):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if quantized:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, **FLOAT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
def test_kernels_match_plain_on_card(quantized, cuda_device):
    """Each kernel against its plain version: a batch that leaves a ragged
    last block, dead rows and holes in ``live``, carries from a first chunk."""
    T, B = 32, 37
    rng = np.random.default_rng(6)
    cfg = Presets.braille(num_ticks=T, quantized=quantized)
    be = ExecutionBackend(cfg, device=cuda_device)
    w_in, w_rec, w_out = be.datapath_weights(_params(rng, cfg))
    dev = cuda_device
    raster = torch.from_numpy((rng.random((T, B, cfg.n_in)) < 0.3)
                              .astype(np.float32)).to(dev)
    valid = torch.from_numpy((rng.random((T, B)) < 0.7).astype(np.float32)).to(dev)
    live = torch.from_numpy((rng.random((T, B)) < 0.8).astype(np.float32)).to(dev)
    live[:, 5] = 0.0
    kw = dict(alpha=be.alpha, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
              reset=cfg.neuron.reset, quant=be.quant)
    ops.reset_launch_counts()
    got = rsnn_step.rsnn_infer_cuda(raster, valid, w_in, w_rec, w_out, **kw)
    want = rsnn_step.rsnn_infer_plain(raster, valid, w_in, w_rec, w_out, **kw)
    for a, b in zip(got, want):
        _check(a, b, quantized)
    carries = list(be.init_session_state(B).values())
    for lo, hi in ((0, T // 2), (T // 2, T)):
        args = (raster[lo:hi].contiguous(), live[lo:hi].contiguous(),
                (valid * live)[lo:hi].contiguous(), *carries, w_in, w_rec, w_out)
        got = rsnn_step.rsnn_step_sessions_cuda(*args, **kw)
        want = rsnn_step.rsnn_step_sessions_plain(*args, **kw)
        for a, b in zip(got, want):
            _check(a, b, quantized)
        carries = list(want)
    assert ops.launches == {"rsnn_infer": 1, "rsnn_step_sessions": 2,
                            "rsnn_forward": 0, "rsnn_train": 0, "eprop_update": 0,
                            "rsnn_train_exact": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
def test_engine_on_card_matches_cpu_engine(quantized, cuda_device):
    """``serve()`` and streaming sessions on the card go through both
    kernels and equal the same engine on the CPU (bitwise when quantized).
    On the card, sessions fed in 7-word chunks equal ``serve()`` bitwise in
    both modes: each row's sums run in an order fixed by the row alone."""
    T = 64
    rng = np.random.default_rng(2)
    cfg = Presets.braille(num_ticks=T, quantized=quantized)
    params = _params(rng, cfg)
    reqs = []
    for i in range(9):
        ticks = int(rng.integers(16, T + 1))
        raster = (rng.random((ticks, cfg.n_in)) < 0.25).astype(np.float32)
        reqs.append(encode_sample(raster, i % 3, label_tick=ticks // 4,
                                  end_tick=ticks - 1))
    ref, _ = BatchedEngine(cfg, params, device="cpu", max_batch=4).serve(iter(reqs))
    ops.reset_launch_counts()
    eng = BatchedEngine(cfg, params, device=cuda_device, max_batch=4,
                        max_sessions=4, tick_tile=8)
    res, _ = eng.serve(iter(reqs))
    for r, g in zip(res, ref):
        _check(torch.from_numpy(r.logits), torch.from_numpy(g.logits), quantized)
    hs = [eng.open_session() for _ in reqs]
    for h, ev in zip(hs, reqs):
        for j in range(0, len(ev), 7):
            h.feed(ev[j:j + 7])
        eng.pump()
    for h, r in zip(hs, res):
        np.testing.assert_array_equal(h.result().logits, r.logits)
    eng.warmup(T, batch=4)
    assert eng.pool.evictions > 0
    assert ops.launches["rsnn_infer"] > 0 and ops.launches["rsnn_step_sessions"] > 0


# The serving kernels' widths with an input density each: Braille, the cue
# net, the chip maximum.  LONG_T runs more than one chunk at every width
# and batch (asserted per case).
SERVE_SHAPES = [((12, 38, 3), 0.12), ((40, 100, 2), 0.1), ((256, 256, 16), 0.05)]
LONG_T = 1100


def _serve_case(dims, density, B, T, quantized, dev, seed):
    """A config at ``dims`` (subtractive reset), weights on the SRAM grid
    (every product and input sum exact in f32 in both modes), a raster,
    a 0/1 valid window and a 0/1 live mask with holes."""
    n, h, o = dims
    rng = np.random.default_rng(seed)
    cfg = Presets.braille(num_ticks=max(T, 1), quantized=quantized, n_in=n, n_hid=h,
                          n_out=o)
    cfg = dataclasses.replace(cfg, neuron=dataclasses.replace(cfg.neuron, reset="sub"))
    be = ExecutionBackend(cfg, device=dev)
    params = {k: (torch.round(v * 16) / 16).clamp(-8, 127 / 16) if k != "alpha" else v
              for k, v in _params(rng, cfg).items()}
    w = be.datapath_weights(params)
    raster = torch.from_numpy((rng.random((T, B, n)) < density).astype(np.float32)).to(dev)
    t = np.arange(T)[:, None]
    start = rng.integers(0, max(T // 2, 1), size=B)
    valid = torch.from_numpy((t >= start).astype(np.float32)).to(dev)
    live = torch.from_numpy((rng.random((T, B)) < 0.9).astype(np.float32)).to(dev)
    kw = dict(alpha=be.alpha, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
              reset=cfg.neuron.reset, quant=be.quant)
    return be, w, raster, valid, live, kw


def _carries(be, B):
    st = be.init_session_state(B)
    return [st[k] for k in ("v", "z", "y", "acc_y", "n_spk")]


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("T", [1, 5, 256, LONG_T])
@pytest.mark.parametrize("B", [1, 7, 512, "admission"])
@pytest.mark.parametrize("dims,density", SERVE_SHAPES)
def test_serving_kernels_match_plain_at_chip_shapes(dims, density, B, T, quantized,
                                                    cuda_device):
    """``rsnn_infer`` and ``rsnn_step_sessions`` (the warp-per-row event
    loop, chunks of ``serve_plan``) against their plain versions: bitwise
    when quantized, within ``FLOAT_TOL`` in float mode; the sessions in two
    chained tiles with live holes, valid within live."""
    B = rsnn_step.max_batch_for_dims(*dims) if B == "admission" else B
    if T == LONG_T:
        assert rsnn_step.serve_plan(T, B, *dims).Tc < T
    be, w, raster, valid, live, kw = _serve_case(dims, density, B, T, quantized,
                                                 cuda_device, seed=B + T)
    for window in ("valid", "all"):
        got = rsnn_step.rsnn_infer_cuda(raster, valid, *w, **kw, infer_window=window)
        want = rsnn_step.rsnn_infer_plain(raster, valid, *w, **kw, infer_window=window)
        for a, b in zip(got, want):
            _check(a, b, quantized)
    carries = _carries(be, B)
    for lo, hi in ((0, T // 2), (T // 2, T)):
        args = (raster[lo:hi].contiguous(), live[lo:hi].contiguous(),
                (valid * live)[lo:hi].contiguous(), *carries, *w)
        got = rsnn_step.rsnn_step_sessions_cuda(*args, **kw)
        want = rsnn_step.rsnn_step_sessions_plain(*args, **kw)
        for a, b in zip(got, want):
            _check(a, b, quantized)
        carries = list(want)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("dims,density", SERVE_SHAPES)
def test_session_tiles_chain_and_equal_inference(dims, density, quantized, cuda_device):
    """On the card, in both modes: a session tile from zero carries with
    every tick live gives ``rsnn_infer``'s bits; ragged chained tiles (one
    of a single tick) give the bits of one whole tile; two launches give
    the same bits."""
    T, B = LONG_T, rsnn_step.max_batch_for_dims(*dims)
    be, w, raster, valid, live, kw = _serve_case(dims, density, B, T, quantized,
                                                 cuda_device, seed=3)
    acc, nspk = rsnn_step.rsnn_infer_cuda(raster, valid, *w, **kw)
    again = rsnn_step.rsnn_infer_cuda(raster, valid, *w, **kw)
    assert torch.equal(acc, again[0]) and torch.equal(nspk, again[1])
    ses = rsnn_step.rsnn_step_sessions_cuda(raster, torch.ones_like(valid), valid,
                                            *_carries(be, B), *w, **kw)
    assert torch.equal(ses[3], acc) and torch.equal(ses[4], nspk)
    vl = (valid * live).contiguous()
    whole = rsnn_step.rsnn_step_sessions_cuda(raster, live, vl, *_carries(be, B), *w, **kw)
    carries = _carries(be, B)
    for lo, hi in ((0, 1), (1, 300), (300, 301), (301, T)):
        carries = rsnn_step.rsnn_step_sessions_cuda(
            raster[lo:hi].contiguous(), live[lo:hi].contiguous(), vl[lo:hi].contiguous(),
            *carries, *w, **kw)
    for a, b in zip(carries, whole):
        assert torch.equal(a, b)
    twice = rsnn_step.rsnn_step_sessions_cuda(raster, live, vl, *_carries(be, B), *w, **kw)
    for a, b in zip(twice, whole):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rsnn_infer", "rsnn_step_sessions"])
def test_serving_launch_refuses_a_plan_it_does_not_lay_out(kernel, cuda_device,
                                                          monkeypatch):
    """The launcher checks the wrapper's plan against its own layout: a
    plan whose shared-memory bytes, or rows a block, disagree is refused,
    nothing runs and nothing is counted."""
    be, w, raster, valid, live, kw = _serve_case((12, 38, 3), 0.12, 64, 32, True,
                                                 cuda_device, seed=1)
    plan = rsnn_step.serve_plan
    calls = {
        "rsnn_infer": lambda: rsnn_step.rsnn_infer_cuda(raster, valid, *w, **kw),
        "rsnn_step_sessions": lambda: rsnn_step.rsnn_step_sessions_cuda(
            raster, live, valid, *_carries(be, 64), *w, **kw),
    }
    for bad in (lambda p: dataclasses.replace(p, smem_bytes=p.smem_bytes + 4),
                lambda p: dataclasses.replace(p, rows=p.threads // 32 + 1)):
        monkeypatch.setattr(rsnn_step, "serve_plan", lambda *a, **k: bad(plan(*a, **k)))
        ops.reset_launch_counts()
        with pytest.raises(RuntimeError, match=f"{kernel} launch failed"):
            calls[kernel]()
        assert ops.launches[kernel] == 0


def _check_dw(got, want):
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= DW_TOL * scale


def _train_case(rng, quantized, feedback, T, B, dev, label_delay=3,
                dims=(12, 38, 3), density=0.3):
    n, h, o = dims
    cfg = Presets.braille(num_ticks=T, quantized=quantized, label_delay=label_delay,
                          n_in=n, n_hid=h, n_out=o)
    cfg = dataclasses.replace(cfg, eprop=dataclasses.replace(cfg.eprop, feedback=feedback))
    be = ExecutionBackend(cfg, device=dev)
    params = {k: v.to(dev) for k, v in _params(rng, cfg).items()}
    params["b_fb"] = torch.from_numpy(
        (rng.normal(size=(cfg.n_hid, cfg.n_out)) / np.sqrt(cfg.n_hid))
        .astype(np.float32)).to(dev)
    raster = torch.from_numpy((rng.random((T, B, cfg.n_in)) < density)
                              .astype(np.float32)).to(dev)
    t = np.arange(T)[:, None]
    start = rng.integers(0, max(T // 2, 1), size=B) + label_delay
    valid = torch.from_numpy((t >= start).astype(np.float32)).to(dev)
    y_star = torch.eye(cfg.n_out, device=dev)[torch.from_numpy(
        rng.integers(0, cfg.n_out, size=B)).to(dev)]
    return cfg, be, params, raster, valid, y_star


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("feedback", ["symmetric", "random"])
def test_train_kernels_match_plain_on_card(quantized, feedback, cuda_device):
    """``rsnn_forward``, ``rsnn_train`` and ``eprop_update`` against their
    plain versions, over a batch that leaves a ragged last block."""
    rng = np.random.default_rng(8)
    cfg, be, params, raster, valid, y_star = _train_case(
        rng, quantized, feedback, 32, 37, cuda_device)
    w_in, w_rec, w_out = be.datapath_weights(params)
    b_fb = be._feedback(params)
    kw = dict(alpha=be.alpha, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
              reset=cfg.neuron.reset, boxcar_width=cfg.neuron.boxcar_width,
              quant=be.quant)
    ops.reset_launch_counts()
    got = rsnn_step.rsnn_forward_cuda(raster, w_in, w_rec, w_out, **kw)
    want = rsnn_step.rsnn_forward_plain(raster, w_in, w_rec, w_out, **kw)
    for k in rsnn_step.FORWARD_KEYS:
        _check(got[k], want[k], quantized)
    tkw = dict(kw, error=cfg.eprop.error, infer_window=cfg.eprop.infer_window)
    args = (raster, y_star, valid, w_in, w_rec, w_out, b_fb)
    got = eprop_update.rsnn_train_cuda(*args, **tkw)
    want = eprop_update.rsnn_train_plain(*args, **tkw)
    _check_dw(got[:3], want[:3])
    for a, b in zip(got[3:], want[3:]):
        _check(a, b, quantized)
    tr = be.forward_traces(params, raster, y_star, valid)
    trs = [tr[k] for k in ("h", "xbar", "pbar", "zbar", "err")]
    got = eprop_update.eprop_update_cuda(*trs, b_fb, kappa=cfg.neuron.kappa)
    want = eprop_update.eprop_update_plain(*trs, b_fb, kappa=cfg.neuron.kappa)
    _check_dw(got, want)
    assert ops.launches == {"rsnn_infer": 0, "rsnn_step_sessions": 0,
                            "rsnn_forward": 2, "rsnn_train": 1, "eprop_update": 1,
                            "rsnn_train_exact": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0}


def _exact_case(rng, quantized, dims, T, B, dev, alpha):
    """An exact-mode tile: the reduced Braille case of ``_train_case`` and
    the ``rsnn_train_exact`` keywords, with ``alpha`` the backend's
    (``"scalar"``) or one decay a neuron in [0.85, 1)."""
    cfg, be, params, raster, valid, y_star = _train_case(
        rng, quantized, "random", T, B, dev, dims=dims)
    a = (torch.tensor(be.alpha) if alpha == "scalar" else torch.from_numpy(
        rng.uniform(0.85, 1.0, size=cfg.n_hid).astype(np.float32))).to(dev)
    args = (raster, y_star, valid, *be.datapath_weights(params), be._feedback(params))
    kw = dict(alpha=a, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
              reset=cfg.neuron.reset, boxcar_width=cfg.neuron.boxcar_width,
              quant=be.quant, error=cfg.eprop.error, infer_window=cfg.eprop.infer_window)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("alpha", ["scalar", "per_neuron"])
@pytest.mark.parametrize("surrogate", ["boxcar", "triangular"])
@pytest.mark.parametrize("dims,T,B,span", [
    ((12, 16, 3), 1, 1, (8, 1)), ((12, 16, 3), 15, 9, (8, 1)),
    ((12, 16, 3), 16, 20, (4, 1)), ((12, 38, 3), 17, 40, (2, 1)),
    ((12, 38, 3), 33, 70, (1, 1)), ((12, 38, 3), 512, 3, (8, 1)),
    ((256, 256, 16), 32, 2, (8, 3)), ((256, 256, 16), 4096, 1, (8, 3))])
def test_train_exact_kernel_matches_plain_on_card(dims, T, B, span, surrogate, alpha,
                                                  quantized, cuda_device):
    """``rsnn_train_exact`` against its plain version at tick counts around
    the ring's tick block (1, 15, 16, 17, 33, 512; 4,096 at 256/256/16),
    over every cluster width the plan takes (``span``: blocks a cluster and
    clusters a row) and under both surrogates: ``dw`` within ``DW_TOL`` of
    its max, ``acc_y`` and ``n_spk`` bitwise when quantized; two launches
    give the same bits; one counted launch each."""
    args, kw = _exact_case(np.random.default_rng(40), quantized, dims, T, B,
                           cuda_device, alpha)
    kw.update(surrogate=surrogate, gamma=0.3)
    plan = rsnn_step.train_exact_plan(T, *dims, B)
    assert (plan.cluster, plan.groups) == span
    ops.reset_launch_counts()
    got = eprop_update.rsnn_train_exact_cuda(*args, **kw)
    again = eprop_update.rsnn_train_exact_cuda(*args, **kw)
    assert ops.launches["rsnn_train_exact"] == 2 and ops.launches["rsnn_train"] == 0
    want = eprop_update.rsnn_train_exact_plain(*args, **kw)
    _check_dw(got[:3], want[:3])
    for a, b in zip(got[3:], want[3:]):
        _check(a, b, quantized)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_train_exact_clocks_and_refused_plans_on_card(cuda_device, monkeypatch):
    """``clocks=`` records every role's start and end of every tick block
    of the first cluster and leaves the outputs' bits alone; a launch whose
    plan the kernel does not lay out (lines a walker not a power of two,
    too few walker threads) raises, with no fallback."""
    from repro_torch.kernels.launch import KernelLaunchError

    args, kw = _exact_case(np.random.default_rng(43), True, (12, 38, 3), 40, 1,
                           cuda_device, "scalar")
    plan = rsnn_step.train_exact_plan(40, 12, 38, 3, 1)
    clocks = torch.zeros(eprop_update.exact_clock_shape(40, plan), dtype=torch.int64,
                         device=cuda_device)
    got = eprop_update.rsnn_train_exact_cuda(*args, **kw, clocks=clocks)
    want = eprop_update.rsnn_train_exact_cuda(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    c = clocks.cpu()
    assert plan.cluster > 1 and bool((c > 0).all()) and bool((c[..., 1] > c[..., 0]).all())
    with pytest.raises(ValueError, match="clocks"):
        eprop_update.rsnn_train_exact_cuda(*args, **kw, clocks=clocks[:, :1])
    for bad in (dataclasses.replace(plan, lines=3),
                dataclasses.replace(plan, cluster=1, g_in=12, g_rec=38, g_out=3, lines=1)):
        monkeypatch.setattr(eprop_update, "train_exact_plan", lambda *a, p=bad: p)
        with pytest.raises(KernelLaunchError):
            eprop_update.rsnn_train_exact_cuda(*args, **kw)


@pytest.mark.cuda
def test_train_exact_commit_grid_on_card(cuda_device):
    """On the commit grid: the codes equal their plain reduce over the
    launch's own partials bitwise, and the plain B=1 loop within the dw
    tolerance plus B lsb; the partials equal the float launch's."""
    from repro_torch.core.quant import DW_COMMIT_SPEC as G

    args, kw = _exact_case(np.random.default_rng(41), True, (12, 38, 3), 64, 11,
                           cuda_device, "per_neuron")
    got = eprop_update.rsnn_train_exact_cuda(*args, **kw, commit_grid=G,
                                             return_partials=True)
    flt = eprop_update.rsnn_train_exact_cuda(*args, **kw, return_partials=True)
    assert got[0].dtype == torch.int32 and torch.equal(got[5], flt[5])
    codes = torch.cat([c.reshape(-1) for c in got[:3]])
    assert torch.equal(codes, eprop_update.dw_codes_reduce_plain(got[5], G))
    want = eprop_update.rsnn_train_exact_plain(*args, **kw, commit_grid=G)
    for g, p, f in zip(got[:3], want[:3], flt[:3]):
        err = float((g - p).abs().max()) * G.lsb
        assert err <= DW_TOL * float(f.abs().max()) + 11 * G.lsb


@pytest.mark.cuda
def test_backend_trains_exact_mode_through_the_kernel(cuda_device):
    """``train_tile`` in exact mode with a per-neuron ``alpha`` in the
    weights launches ``rsnn_train_exact`` (not ``rsnn_train``) and gives the
    CPU backend's ``dw`` within ``DW_TOL``; a per-neuron alpha in factored
    mode raises."""
    rng = np.random.default_rng(42)
    cfg, be, params, raster, valid, y_star = _train_case(rng, True, "random", 64, 5,
                                                         cuda_device)
    cfg = dataclasses.replace(cfg, eprop=dataclasses.replace(cfg.eprop, mode="exact"))
    params["alpha"] = torch.from_numpy(rng.uniform(0.85, 1.0, size=cfg.n_hid)
                                       .astype(np.float32)).to(cuda_device)
    ops.reset_launch_counts()
    got, gm = ExecutionBackend(cfg, device=cuda_device).train_tile(params, raster, y_star,
                                                                  valid)
    assert ops.launches["rsnn_train_exact"] == 1 and ops.launches["rsnn_train"] == 0
    cpu = {k: v.cpu() for k, v in params.items()}
    want, wm = ExecutionBackend(cfg, device="cpu").train_tile(
        cpu, raster.cpu(), y_star.cpu(), valid.cpu())
    _check_dw([got[k].cpu() for k in want], list(want.values()))
    assert torch.equal(gm["acc_y"].cpu(), wm["acc_y"])
    with pytest.raises(ValueError, match="scalar alpha"):
        be.train_tile(params, raster, y_star, valid)


@pytest.mark.cuda
def test_train_kernel_dw_identical_across_launches(cuda_device):
    """No atomics: two launches of ``rsnn_train`` (and of ``eprop_update``)
    on the same inputs give the same bits, and the split pipeline's ``dw``
    equals the fused one within the tolerance."""
    rng = np.random.default_rng(9)
    cfg, be, params, raster, valid, y_star = _train_case(
        rng, True, "symmetric", 64, 70, cuda_device)
    a, _ = be.train_tile(params, raster, y_star, valid)
    b, _ = be.train_tile(params, raster, y_star, valid)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    tr = be.forward_traces(params, raster, y_star, valid)
    c, d = be.eprop_update(params, tr), be.eprop_update(params, tr)
    for k in c:
        assert torch.equal(c[k], d[k]), k
    _check_dw([c[k] for k in a], [a[k] for k in a])


# Braille's 12/38/3 and the chip maximum 256/256/16, whose trace set never
# fits a block (the device-scratch path)
TRAIN_SHAPES = [((12, 38, 3), 0.3), ((256, 256, 16), 0.05)]


def _train_full(dims, density, T, B, quantized, dev, seed):
    rng = np.random.default_rng(seed)
    cfg, be, params, raster, valid, y_star = _train_case(
        rng, quantized, "random", T, B, dev, dims=dims, density=density)
    # weights on the SRAM grid in both modes: every product and current is
    # exact in f32, so float mode's spikes cannot flip on a summation order
    params = {k: (torch.round(v * 16) / 16).clamp(-8, 127 / 16)
              if k in ("w_in", "w_rec", "w_out") else v for k, v in params.items()}
    w_in, w_rec, w_out = be.datapath_weights(params)
    kw = dict(alpha=be.alpha, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
              reset=cfg.neuron.reset, boxcar_width=cfg.neuron.boxcar_width,
              quant=be.quant, error=cfg.eprop.error,
              infer_window=cfg.eprop.infer_window)
    args = (raster, y_star, valid, w_in, w_rec, w_out, be._feedback(params))
    return cfg, args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("B", [1, 70, 512])
@pytest.mark.parametrize("dims,density", TRAIN_SHAPES)
def test_train_kernel_matches_plain_at_chip_shapes(dims, density, B, T, quantized,
                                                   cuda_device):
    """``rsnn_train`` (the warp-per-row event loop, one block a row) against
    its plain version at END_S's B=1, the END_B tile's B=70 and B=512:
    ``acc_y``, ``n_spk`` and the traces bitwise when quantized, ``dw``
    within ``DW_TOL``; two launches give the same bits."""
    cfg, args, kw = _train_full(dims, density, T, B, quantized, cuda_device, seed=B + T)
    plan = rsnn_step.train_plan(T, *dims)
    assert plan.traces_smem == (dims == (12, 38, 3))
    _check_train_kernel(args, kw, quantized)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("B", [1, 70])
def test_train_kernel_device_trace_path_at_long_T(B, quantized, cuda_device):
    """At T=512 a Braille row's trace set (264 KB) no longer fits a block:
    the same kernel runs its phases on the device scratch."""
    T, dims = 512, (12, 38, 3)
    assert not rsnn_step.train_plan(T, *dims).traces_smem
    cfg, args, kw = _train_full(dims, 0.3, T, B, quantized, cuda_device, seed=B)
    _check_train_kernel(args, kw, quantized)


def _train_layout(monkeypatch, plan, T, cluster, ticks):
    """Make ``rsnn_train_cuda`` launch ``plan`` (at T ticks) with another
    cluster and tick block, its shared-memory bytes those of the new tick
    block."""
    smem = (plan.smem_bytes - rsnn_step.train_barrier_bytes(T, plan.ticks)
            + rsnn_step.train_barrier_bytes(T, ticks))
    forced = dataclasses.replace(plan, cluster=cluster, ticks=ticks, smem_bytes=smem)
    monkeypatch.setattr(eprop_update, "train_plan", lambda *a, **k: forced)


def _train_outputs(args, kw):
    """One layout's outputs: ``dw``, ``acc_y``, ``n_spk``, the per-row
    partials and the traces, then the codes on the commit grid."""
    from repro_torch.core.quant import DW_COMMIT_SPEC as G

    out = eprop_update.rsnn_train_cuda(*args, **kw, return_partials=True,
                                       return_traces=True)
    codes = eprop_update.rsnn_train_cuda(*args, **kw, commit_grid=G, return_partials=True)
    return [*out[:6], *(out[6][k] for k in eprop_update.TRACE_KEYS), *codes[:3], codes[5]]


@pytest.mark.cuda
@pytest.mark.parametrize("surrogate", ["boxcar", "triangular"])
@pytest.mark.parametrize("B", [1, 2, 70])
@pytest.mark.parametrize("T", [1, 31, 128, 256, 425])
def test_train_kernel_layouts_give_the_same_bits_on_card(T, B, surrogate, cuda_device,
                                                         monkeypatch):
    """Quantized ``rsnn_train`` at every layout its launcher takes: a row
    on 1, 2, 4 or 8 blocks of a cluster (with the trace set in shared
    memory; one block on the device scratch at T=425) and tick blocks of
    1, 16 and 32 ticks give the bits of the one-block layout: ``dw``, each
    row's partial, ``acc_y``, ``n_spk``, the traces, and the codes on the
    commit grid with their partials; and the plain version's (``acc_y``,
    ``n_spk``, ``h, xbar, pbar, zbar`` bitwise, ``dw`` within ``DW_TOL``,
    ``err`` within ``ERR_TOL``)."""
    cfg, args, kw = _train_full((12, 38, 3), 0.3, T, B, True, cuda_device, seed=T + B)
    if surrogate == "triangular":
        kw.update(surrogate="triangular", gamma=0.3)
    plan = rsnn_step.train_plan(T, 12, 38, 3, B)
    assert plan.traces_smem == (T <= 424)
    assert plan.cluster == (1 if B == 70 or not plan.traces_smem else 8)
    _train_layout(monkeypatch, plan, T, 1, plan.ticks)
    ref = _train_outputs(args, kw)
    layouts = [(c, plan.ticks) for c in (2, 4, 8)] + [(8, 1), (2, 32), (1, 32)]
    for cluster, ticks in layouts if plan.traces_smem else [(1, 1), (1, 32)]:
        _train_layout(monkeypatch, plan, T, cluster, ticks)
        got = _train_outputs(args, kw)
        for i, (a, b) in enumerate(zip(got, ref)):
            assert torch.equal(a, b), (cluster, ticks, i)
    monkeypatch.undo()
    ops.reset_launch_counts()
    assert all(torch.equal(a, b) for a, b in zip(_train_outputs(args, kw), ref))
    assert ops.launches["rsnn_train"] == 2
    want = eprop_update.rsnn_train_plain(*args, **kw, return_traces=True)
    _check_dw(ref[:3], want[:3])
    for a, b in zip(ref[3:5], want[3:5]):
        _check(a, b, True)
    for i, k in enumerate(eprop_update.TRACE_KEYS):
        if k == "err":
            np.testing.assert_allclose(ref[6 + i].cpu().numpy(), want[5][k].cpu().numpy(),
                                       **ERR_TOL)
        else:
            _check(ref[6 + i], want[5][k], True)


@pytest.mark.cuda
def test_train_clocks_and_refused_plans_on_card(cuda_device, monkeypatch):
    """``clocks=`` records every role of row 0 (block 1 too, at END_S's
    eight blocks a row) and leaves the outputs' bits alone; a launch whose
    plan the kernel does not lay out (a cluster of 3 or 16, a cluster on
    the device scratch, no ticks a block, other threads or bytes) raises,
    with no fallback, and counts nothing."""
    cfg, args, kw = _train_full((12, 38, 3), 0.3, 128, 1, True, cuda_device, seed=5)
    clocks = torch.zeros((len(eprop_update.TRAIN_CLOCK_ROLES), 2), dtype=torch.int64,
                         device=cuda_device)
    got = eprop_update.rsnn_train_cuda(*args, **kw, clocks=clocks)
    want = eprop_update.rsnn_train_cuda(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    c = clocks.cpu()
    assert bool((c > 0).all()) and bool((c[:, 1] > c[:, 0]).all())
    with pytest.raises(ValueError, match="clocks"):
        eprop_update.rsnn_train_cuda(*args, **kw, clocks=clocks[:1])
    plan = rsnn_step.train_plan(128, 12, 38, 3, 1)
    long_args = _train_full((12, 38, 3), 0.3, 512, 1, True, cuda_device, seed=6)[1]
    long_plan = rsnn_step.train_plan(512, 12, 38, 3, 1)
    for bad, a in ((dataclasses.replace(plan, cluster=3), args),
                   (dataclasses.replace(plan, cluster=16), args),
                   (dataclasses.replace(long_plan, cluster=2), long_args),
                   (dataclasses.replace(plan, ticks=0), args),
                   (dataclasses.replace(plan, threads=256), args),
                   (dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 4), args)):
        monkeypatch.setattr(eprop_update, "train_plan", lambda *x, p=bad, **k: p)
        ops.reset_launch_counts()
        with pytest.raises(RuntimeError, match="rsnn_train launch failed"):
            eprop_update.rsnn_train_cuda(*a, **kw)
        assert ops.launches["rsnn_train"] == 0


# rsnn_forward's shapes: END_S's one row, a ragged END_B-sized batch, 2,048
# rows (two a block; a ragged last block at 2,001), T=512 (row buffers
# still in shared memory), T=4,096 (row buffers in the device streams;
# three rows a block and the readout in chunks at 2,200 rows), the cue width
# and the chip maximum (weights read from L2; the readout in chunks at
# T=4,096)
FORWARD_CASES = [
    ((12, 38, 3), 0.3, 128, 1),
    ((12, 38, 3), 0.3, 128, 37),
    ((12, 38, 3), 0.3, 128, 2048),
    ((12, 38, 3), 0.3, 128, 2001),
    ((12, 38, 3), 0.3, 512, 37),
    ((12, 38, 3), 0.3, 4096, 3),
    ((12, 38, 3), 0.3, 4096, 2200),
    ((40, 100, 2), 0.1, 256, 37),
    ((40, 100, 2), 0.1, 128, 3000),
    ((256, 256, 16), 0.05, 128, 8),
    ((256, 256, 16), 0.05, 128, 1500),
    ((256, 256, 16), 0.05, 4096, 2),
]


def _forward_args(dims, density, T, B, quantized, dev, seed):
    cfg, args, kw = _train_full(dims, density, T, B, quantized, dev, seed=seed)
    fkw = {k: kw[k] for k in ("alpha", "kappa", "v_th", "reset", "boxcar_width", "quant")}
    return args[0], args[3:6], fkw


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("dims,density,T,B", FORWARD_CASES)
def test_forward_kernel_matches_plain_at_chip_shapes(dims, density, T, B, quantized,
                                                     cuda_device):
    """``rsnn_forward`` (the warp-per-row event loop, a loop warp a row,
    up to 16 rows a block) against its plain version: the seven streams
    bitwise when quantized, within ``FLOAT_TOL`` in float mode; two
    launches give the same bits."""
    raster, w, kw = _forward_args(dims, density, T, B, quantized, cuda_device, seed=B + T)
    ops.reset_launch_counts()
    got = rsnn_step.rsnn_forward_cuda(raster, *w, **kw)
    again = rsnn_step.rsnn_forward_cuda(raster, *w, **kw)
    assert ops.launches["rsnn_forward"] == 2
    want = rsnn_step.rsnn_forward_plain(raster, *w, **kw)
    for k in rsnn_step.FORWARD_KEYS:
        _check(got[k], want[k], quantized)
        assert torch.equal(got[k], again[k]), k


@pytest.mark.cuda
def test_forward_launch_refuses_a_plan_it_does_not_lay_out(cuda_device, monkeypatch):
    """The launcher checks ``forward_plan`` against its own layout: a plan
    whose shared-memory bytes, rows a block, readout chunk, buffer
    placement or threads disagree is refused, nothing runs and nothing is
    counted."""
    raster, w, kw = _forward_args((12, 38, 3), 0.3, 32, 8, True, cuda_device, seed=1)
    plan = rsnn_step.forward_plan
    for bad in (lambda p: dataclasses.replace(p, smem_bytes=p.smem_bytes + 4),
                lambda p: dataclasses.replace(p, rows=2),
                lambda p: dataclasses.replace(p, Tl=p.Tl - 1),
                lambda p: dataclasses.replace(p, rows_smem=not p.rows_smem),
                lambda p: dataclasses.replace(p, threads=32 * p.rows)):
        monkeypatch.setattr(rsnn_step, "forward_plan", lambda *a, **k: bad(plan(*a, **k)))
        ops.reset_launch_counts()
        with pytest.raises(RuntimeError, match="rsnn_forward launch failed"):
            rsnn_step.rsnn_forward_cuda(raster, *w, **kw)
        assert ops.launches["rsnn_forward"] == 0


def _check_train_kernel(args, kw, quantized):
    ops.reset_launch_counts()
    got = eprop_update.rsnn_train_cuda(*args, **kw, return_traces=True)
    again = eprop_update.rsnn_train_cuda(*args, **kw)
    want = eprop_update.rsnn_train_plain(*args, **kw, return_traces=True)
    assert ops.launches["rsnn_train"] == 2
    _check_dw(got[:3], want[:3])
    for a, b in zip(got[3:5], want[3:5]):
        _check(a, b, quantized)
    for k in ("h", "xbar", "pbar", "zbar"):
        _check(got[5][k], want[5][k], quantized)
    np.testing.assert_allclose(got[5]["err"].cpu().numpy(), want[5]["err"].cpu().numpy(),
                               **(ERR_TOL if quantized else FLOAT_TOL))
    for a, b in zip(got[:5], again):
        assert torch.equal(a, b)


# The surrogates the trace kernels take besides the default boxcar: the
# triangular, and a boxcar of another width.
SURROGATE_KW = {"triangular": dict(surrogate="triangular", gamma=0.3),
                "boxcar_w025": dict(surrogate="boxcar", boxcar_width=0.25)}


@pytest.mark.cuda
@pytest.mark.parametrize("surrogate", list(SURROGATE_KW))
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("dims,density,T,B", [((12, 38, 3), 0.3, 128, 1),
                                              ((12, 38, 3), 0.3, 128, 70),
                                              ((12, 38, 3), 0.3, 512, 3),
                                              ((256, 256, 16), 0.05, 128, 8)])
def test_trace_kernels_follow_the_surrogate_on_card(dims, density, T, B, quantized,
                                                    surrogate, cuda_device):
    """``rsnn_forward``, ``rsnn_train`` and ``rsnn_train_exact`` under the
    triangular surrogate and a boxcar of half-width 0.25, against their
    plain versions (the tolerances of their default-boxcar tests; each
    trace set in shared memory and on the device scratch), and each
    kernel's ``h`` or ``dw`` another than the default boxcar's."""
    cfg, args, kw = _train_full(dims, density, T, B, quantized, cuda_device, seed=B + T + 1)
    base = dict(kw)
    kw.update(SURROGATE_KW[surrogate])
    fkw = {k: v for k, v in kw.items() if k not in ("error", "infer_window")}
    ops.reset_launch_counts()
    got = rsnn_step.rsnn_forward_cuda(args[0], *args[3:6], **fkw)
    want = rsnn_step.rsnn_forward_plain(args[0], *args[3:6], **fkw)
    for k in rsnn_step.FORWARD_KEYS:
        _check(got[k], want[k], quantized)
    boxcar = rsnn_step.rsnn_forward_cuda(
        args[0], *args[3:6], **{k: v for k, v in base.items() if k in fkw})
    assert not torch.equal(got["h"], boxcar["h"])
    if surrogate == "triangular":
        assert bool(((got["h"] > 0) & (got["h"] < 0.3)).any())
    _check_train_kernel(args, kw, quantized)
    ops.reset_launch_counts()
    exact = eprop_update.rsnn_train_exact_cuda(*args, **kw)
    want = eprop_update.rsnn_train_exact_plain(*args, **kw)
    _check_dw(exact[:3], want[:3])
    for a, b in zip(exact[3:], want[3:]):
        _check(a, b, quantized)
    other = eprop_update.rsnn_train_exact_cuda(*args, **base)
    assert any(float((a - b).abs().max()) > 100 * DW_TOL * float(b.abs().max())
               for a, b in zip(exact[:3], other[:3]))
    assert ops.launches["rsnn_train_exact"] == 2


@pytest.mark.cuda
def test_unknown_surrogate_is_refused_before_a_launch(cuda_device):
    """An unknown surrogate raises ``ValueError`` from each trace kernel's
    wrapper on the card, and nothing is launched."""
    cfg, args, kw = _train_full((12, 38, 3), 0.3, 32, 2, True, cuda_device, seed=5)
    kw["surrogate"] = "sigmoid"
    fkw = {k: v for k, v in kw.items() if k not in ("error", "infer_window")}
    ops.reset_launch_counts()
    for call in (lambda: rsnn_step.rsnn_forward_cuda(args[0], *args[3:6], **fkw),
                 lambda: eprop_update.rsnn_train_cuda(*args, **kw),
                 lambda: eprop_update.rsnn_train_exact_cuda(*args, **kw)):
        with pytest.raises(ValueError, match="surrogate"):
            call()
    assert all(n == 0 for n in ops.launches.values())


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("B", [1, 70, 512])
@pytest.mark.parametrize("dims,density", TRAIN_SHAPES)
def test_eprop_update_matches_plain_at_chip_shapes(dims, density, B, quantized,
                                                   cuda_device):
    """The split reverse pass over the plain version's traces, against its
    plain version; two launches give the same bits."""
    cfg, args, kw = _train_full(dims, density, 128, B, quantized, cuda_device, seed=B)
    tr = eprop_update.rsnn_train_plain(*args, **kw, return_traces=True)[5]
    trs = [tr[k].contiguous() for k in eprop_update.TRACE_KEYS]
    b_fb = args[-1]
    ops.reset_launch_counts()
    got = eprop_update.eprop_update_cuda(*trs, b_fb, kappa=cfg.neuron.kappa)
    again = eprop_update.eprop_update_cuda(*trs, b_fb, kappa=cfg.neuron.kappa)
    assert ops.launches["eprop_update"] == 2
    _check_dw(got, eprop_update.eprop_update_plain(*trs, b_fb, kappa=cfg.neuron.kappa))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def _flash_case(rng, B, Sq, Skv, H, Hkv, D, dtype, dev, strided, DV=None):
    """q, k at width D and v at width DV (default D); ``strided`` makes them
    views of head-major tensors."""
    def one(S, heads, width):
        x = rng.normal(size=(B, heads, S, width) if strided else (B, S, heads, width)) * 0.3
        x = torch.from_numpy(x.astype(np.float32)).to(dev, dtype)
        return x.transpose(1, 2) if strided else x
    return one(Sq, H, D), one(Skv, Hkv, D), one(Skv, Hkv, D if DV is None else DV)


# the tensor-core kernel's cases at the model widths D = 64 and 128:
# Sq not a multiple of the 128-query tile, GQA 4:1 and 1:1, non-causal with
# NaN past kv_len, strided views
TENSOR_CORE_CASES = [
    case for D in (64, 128) for case in (
        (2, 200, 200, 16, 4, D, True, None, False),
        (2, 256, 256, 8, 8, D, True, None, False),
        (1, 150, 300, 8, 2, D, False, 237, False),
        (2, 130, 130, 8, 2, D, True, None, True),
        (1, 100, 400, 4, 4, D, False, 333, True),
    )
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,kv_len,strided", [
    (2, 128, 128, 8, 2, 64, True, None, False),       # GQA, whole tiles
    (1, 200, 200, 4, 4, 128, True, None, False),      # MHA, ragged
    (2, 70, 150, 4, 1, 16, False, 131, True),         # strided, kv_len < Skv
    (1, 1, 65, 4, 2, 32, False, None, False),         # one query
    (1, 130, 90, 4, 2, 64, True, None, True),         # more queries than keys
    *TENSOR_CORE_CASES,
])
def test_flash_kernel_matches_plain_on_card(dtype, B, Sq, Skv, H, Hkv, D, causal,
                                            kv_len, strided, cuda_device):
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(Sq * 7 + Skv)
    q, k, v = _flash_case(rng, B, Sq, Skv, H, Hkv, D, dtype, cuda_device, strided)
    if kv_len is not None:
        k[:, kv_len:] = float("nan")
        v[:, kv_len:] = float("nan")
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    again = ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    want = FA.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    assert ops.launches["flash_attention"] == 2
    assert got.dtype == dtype and got.shape == (B, Sq, H, D)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    if dtype == torch.float32:
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert err <= FLASH_F32_TOL, err
    else:
        err = FA.row_error(got, want)
        assert err <= FA.BF16_ROW_TOL, err


@pytest.mark.cuda
def test_flash_kernel_identical_across_launches(cuda_device):
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(2)
    q, k, v = _flash_case(rng, 2, 300, 300, 8, 2, 128, torch.bfloat16, cuda_device,
                          False)
    a = FA.flash_attention_cuda(q, k, v, causal=True)
    b = FA.flash_attention_cuda(q, k, v, causal=True)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="head width"):
        FA.flash_attention_cuda(q[..., :8], k[..., :8], v[..., :8], causal=True)


@pytest.mark.cuda
def test_flash_bf16_gate_rejects_planted_faults(cuda_device):
    """The bf16 gate (``row_error <= BF16_ROW_TOL``) rejects the output
    scaled by 0.9 and the kernel's output with key tile 64-127 lost from
    the later rows, as ``chip_smoke.py`` (j) checks at the llama shape."""
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(12)
    q, k, v = _flash_case(rng, 2, 512, 512, 8, 2, 128, torch.bfloat16, cuda_device,
                          False)
    got = FA.flash_attention_cuda(q, k, v, causal=True)
    want = FA.flash_attention_plain(q, k, v, causal=True)
    assert FA.row_error(got, want) <= FA.BF16_ROW_TOL
    lost = v.clone()
    lost[:, 64:128] = 0
    fault = got.clone()
    fault[:, 256:] = FA.flash_attention_cuda(q, k, lost, causal=True)[:, 256:]
    assert FA.row_error(fault, want) > FA.BF16_ROW_TOL
    assert FA.row_error((got.float() * 0.9).to(torch.bfloat16), want) > FA.BF16_ROW_TOL


@pytest.mark.cuda
def test_flash_bf16_misaligned_stride_raises(cuda_device):
    """A head stride of 68 elements moves the rows off the 16-byte grid
    that the kernel's copies need: the wrapper raises, nothing launches."""
    from repro_torch.kernels import flash_attention as FA

    bf16 = torch.bfloat16
    q = torch.zeros(1, 64, 4, 68, dtype=bf16, device=cuda_device)[..., :64]
    k = torch.zeros(1, 64, 2, 64, dtype=bf16, device=cuda_device)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention_cuda(q, k, k, causal=True)
    assert ops.launches["flash_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-1.7b", "qwen1.5-32b", "yi-34b"])
def test_reduced_dense_generate_on_card_matches_cpu(arch, cuda_device):
    """A reduced dense model in f32 gives the same greedy tokens on the
    card (through the flash kernel) as on the CPU (plain version)."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.models.model import build
    from repro_torch.models.transformer import tree_map
    from repro_torch.train.serve_step import generate

    cfg = get_reduced(arch)
    model = build(cfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)))
    want = generate(model, params, {"tokens": toks}, 8, 56)
    ops.reset_launch_counts()
    got = generate(model, tree_map(lambda t: t.to(cuda_device), params),
                   {"tokens": toks.to(cuda_device)}, 8, 56)
    assert ops.launches["flash_attention"] == cfg.n_layers
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# the hardened engine on the card: launch faults, sticky errors, publishing
# mid-serve, the NaN quarantine
# ---------------------------------------------------------------------------


def _hardening_case(seed=3, n=12, T=64):
    rng = np.random.default_rng(seed)
    cfg = Presets.braille(num_ticks=T, quantized=True)
    params = _params(rng, cfg)
    reqs = []
    for i in range(n):
        ticks = int(rng.integers(16, T + 1))
        raster = (rng.random((ticks, cfg.n_in)) < 0.25).astype(np.float32)
        reqs.append(encode_sample(raster, i % 3, label_tick=ticks // 4,
                                  end_tick=ticks - 1))
    return cfg, params, reqs


def _fail_hook(kind, at, exc, seen):
    count = [0]

    def hook(model_id, k):
        if k == kind:
            count[0] += 1
            if count[0] == at:
                seen.append(dict(ops.launches))
                raise exc

    return hook


def _in_halves(eng, reqs):
    hs = [eng.open_session() for _ in reqs]
    for part in (0, 1):
        for h, ev in zip(hs, reqs):
            if h.status.value == "ok":
                mid = len(ev) // 2
                h.feed(ev[:mid] if part == 0 else ev[mid:])
        eng.pump()
    return [h.result() for h in hs]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tile", "stream"])
def test_injected_launch_fault_recovers_bitwise_on_kernel(kind, cuda_device):
    """A launch fault restarts the lane on the card (never the CPU, never
    the plain version): the rebuilt backend is on the same device, the
    kernel's launch counter rises after the restart, and the answers equal
    an undisturbed card run bitwise."""
    cfg, params, reqs = _hardening_case()

    def run(hook):
        eng = BatchedEngine(cfg, params, device=cuda_device, max_batch=4,
                            tick_tile=16, fault_hook=hook)
        if kind == "tile":
            res, _ = eng.serve(iter(reqs))
        else:
            res = _in_halves(eng, reqs)
        torch.cuda.synchronize()
        return eng, res

    _, clean = run(None)
    seen = []
    eng, got = run(_fail_hook(kind, 1 if kind == "tile" else 2,
                              RuntimeError("injected"), seen))
    assert eng.stream_stats(1.0).lane_restarts == 1 and len(seen) == 1
    assert eng.engine.device == cuda_device
    assert ops.launches["rsnn_step_sessions"] > seen[0]["rsnn_step_sessions"]
    for g, w in zip(got, clean):
        assert g.status.value == "ok"
        np.testing.assert_array_equal(g.logits, w.logits)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tile", "stream"])
def test_sticky_launch_error_reaches_caller_on_card(kind, cuda_device):
    """A stand-in for a sticky CUDA error (an illegal address, code 700)
    raised at a launch is re-raised to the caller: no lane restart, no
    quarantine, no FAULT results in its place."""
    from repro_torch.kernels.launch import KernelLaunchError

    cfg, params, reqs = _hardening_case(n=6)
    sticky = KernelLaunchError("rsnn_step_sessions", 700,
                               "an illegal memory access was encountered")
    eng = BatchedEngine(cfg, params, device=cuda_device, max_batch=4, tick_tile=16,
                        fault_hook=_fail_hook(kind, 1, sticky, []))
    with pytest.raises(KernelLaunchError, match="CUDA error 700"):
        if kind == "tile":
            eng.serve(iter(reqs))
        else:
            _in_halves(eng, reqs)
    stats = eng.stream_stats(1.0)
    assert stats.lane_restarts == 0 and stats.quarantined == 0


@pytest.mark.cuda
def test_publish_mid_serve_keeps_launched_tiles_image(cuda_device):
    """Tiles launched before a publish read the image they were launched
    with, even while still in flight; tiles launched after it read the new
    one.  Both equal an engine on the CPU given the same images."""
    from repro_torch.serve import ModelRegistry

    cfg, params, reqs = _hardening_case(n=8)
    new = {k: (v * -1.5 if k.startswith("w_") else v) for k, v in params.items()}
    reg = ModelRegistry()
    reg.register("live", cfg, params, device=cuda_device)
    # one bucket (T <= 64): every tile is four consecutive requests
    kw = dict(max_batch=4, tick_granularity=64)
    eng = BatchedEngine(registry=reg, device=cuda_device, max_inflight_tiles=64, **kw)

    def stream():
        for i, ev in enumerate(reqs):
            yield ev
            if i == 3:             # the first tile has just launched
                reg.update_weights("live", {k: v.to(cuda_device) for k, v in new.items()})

    res, _ = eng.serve(stream())
    old_ref, _ = BatchedEngine(cfg, params, device="cpu", **kw).serve(iter(reqs[:4]))
    new_ref, _ = BatchedEngine(cfg, new, device="cpu", **kw).serve(iter(reqs[4:]))
    assert reg.get("live").swaps == 1
    for r, g in zip(res, old_ref + new_ref):
        np.testing.assert_array_equal(r.logits, g.logits)
    assert not all(np.array_equal(a.logits, b.logits) for a, b in zip(old_ref, new_ref))


@pytest.mark.cuda
def test_nan_quarantine_leaves_tile_mates_unchanged_on_card(cuda_device):
    """A NaN planted in one session's harvested readout quarantines that
    session only; its tile-mates come out bitwise unchanged."""
    cfg, params, reqs = _hardening_case(n=6)

    def run(victim):
        eng = BatchedEngine(cfg, params, device=cuda_device, max_batch=8, tick_tile=16)
        if victim is not None:
            orig = eng._launch_chunks

            def poisoned(lane, sessions, chunks, num_ticks):
                out = orig(lane, sessions, chunks, num_ticks)
                for i, s in enumerate(sessions):
                    if s.sid == victim:
                        acc = out["acc_y"].clone()
                        acc[i] = float("nan")
                        out = dict(out, acc_y=acc)
                return out

            eng._launch_chunks = poisoned
        return eng, _in_halves(eng, reqs)

    _, clean = run(None)
    eng, got = run(2)
    assert [s.sid for s in got if s.status.value != "ok"] == [2]
    assert got[2].status.value == "fault" and got[2].pred == -1
    assert eng.stream_stats(1.0).quarantined == 1
    for i, (g, w) in enumerate(zip(got, clean)):
        if i != 2:
            np.testing.assert_array_equal(g.logits, w.logits)


@pytest.mark.cuda
def test_chaos_sigkill_resumes_bitwise_on_card(cuda_device, tmp_path):
    """A chaos worker on the card (the worker's default device), SIGKILLed
    at commit 2 once a checkpoint is on disk and restarted, ends bitwise on
    an uninterrupted run on the card, with rsnn_train launched in every
    worker; a learner restored from those checkpoints re-publishes into a
    registry, and an engine lane on the card serves the restored image
    bitwise as an engine on the CPU does."""
    import signal

    from repro_torch.data.braille import BrailleConfig, make_braille_dataset
    from repro_torch.data.pipeline import EventStream
    from repro_torch.serve import ModelRegistry
    from repro_torch.train import chaos

    kw = dict(epochs=2, samples_per_class=8, num_ticks=32, spb=12)
    gold = chaos.golden_run(device=cuda_device, **kw)
    out = str(tmp_path / "result")
    res = chaos.run_chaos(str(tmp_path / "ck"), out, ["--kill-at-commit", 2],
                          ["--epochs", 2, "--samples-per-class", 8, "--ticks", 32,
                           "--spb", 12])
    got = chaos.load_result_weights(out)
    assert sorted(got) == sorted(gold)
    for k in gold:
        np.testing.assert_array_equal(got[k], gold[k])
    assert res["spawns"][0]["rc"] == -signal.SIGKILL and res["resumed_from"] is not None
    for sp in res["spawns"]:
        assert sp["status"]["device"] == "cuda" and sp["status"]["rsnn_train"] > 0

    reg = ModelRegistry()
    b, _ = chaos.build_learner(str(tmp_path / "ck"), device=cuda_device, registry=reg,
                               seed=17, **kw)
    eng = BatchedEngine(registry=reg, model_id=b.model_id, device=cuda_device,
                        max_batch=4, tick_granularity=32)
    assert b.restore_checkpoint()
    for k in gold:
        np.testing.assert_array_equal(b.weights[k].cpu().numpy(), gold[k])
    data = make_braille_dataset("AEU", BrailleConfig(samples_per_class=8, num_ticks=32))
    reqs = list(EventStream(data, "test"))
    ops.reset_launch_counts()
    res_card, _ = eng.serve(iter(reqs))
    assert ops.launches["rsnn_step_sessions"] > 0      # serve()'s whole-sample tiles
    host = {k: v.cpu() for k, v in b.inference_params().items()}
    res_cpu, _ = BatchedEngine(b.cfg, host, device="cpu", max_batch=4,
                               tick_granularity=32).serve(iter(reqs))
    for r, w in zip(res_card, res_cpu):
        assert r.pred == w.pred
        np.testing.assert_array_equal(r.logits, w.logits)


# ------------------------------------------------ the integer commit grid

def _grid_codes(out):
    return torch.cat([c.reshape(-1) for c in out[:3]])


def _shard_sum(args, kw, shards):
    """The int32 sum of the codes of ``shards`` launches over a padded
    split of the rows (zero raster, y* and valid in the padding)."""
    from repro_torch.core.quant import DW_COMMIT_SPEC

    raster, y_star, valid, *w = args
    B = raster.shape[1]
    per = -(-B // shards)
    pad = per * shards - B
    raster = torch.cat([raster, raster.new_zeros((raster.shape[0], pad, raster.shape[2]))], 1)
    y_star = torch.cat([y_star, y_star.new_zeros((pad, y_star.shape[1]))])
    valid = torch.cat([valid, valid.new_zeros((valid.shape[0], pad))], 1)
    total = 0
    for i in range(shards):
        sl = slice(i * per, (i + 1) * per)
        total = total + _grid_codes(eprop_update.rsnn_train_cuda(
            raster[:, sl].contiguous(), y_star[sl].contiguous(), valid[:, sl].contiguous(),
            *w, **kw, commit_grid=DW_COMMIT_SPEC))
    return total


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("dims,density,B", [((12, 38, 3), 0.3, 1), ((12, 38, 3), 0.3, 11),
                                            ((12, 38, 3), 0.3, 70),
                                            ((256, 256, 16), 0.05, 8)])
def test_commit_grid_codes_match_plain_and_any_split(dims, density, B, quantized,
                                                     cuda_device):
    """``rsnn_dw_codes_reduce_kernel``: the codes equal its plain version over
    the same per-row partials bitwise, and the plain B=1 loop within the dw
    tolerance plus B lsb; the codes of one launch equal the int32 sums of
    8-way, 4-way and one-row launches over the same rows, bitwise."""
    from repro_torch.core.quant import DW_COMMIT_SPEC as G

    cfg, be, params, raster, valid, y_star = _train_case(
        np.random.default_rng(17), quantized, "symmetric", 64, B, cuda_device,
        dims=dims, density=density)
    args = (raster, y_star, valid, *be.datapath_weights(params), be._feedback(params))
    kw = dict(alpha=be.alpha, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
              reset=cfg.neuron.reset, boxcar_width=cfg.neuron.boxcar_width,
              quant=be.quant, error=cfg.eprop.error, infer_window=cfg.eprop.infer_window)
    ops.reset_launch_counts()
    got = eprop_update.rsnn_train_cuda(*args, **kw, commit_grid=G, return_partials=True)
    assert ops.launches["rsnn_train"] == 1 and got[0].dtype == torch.int32
    codes = _grid_codes(got)
    assert torch.equal(codes, eprop_update.dw_codes_reduce_plain(got[5], G))
    flt = eprop_update.rsnn_train_cuda(*args, **kw, return_partials=True)
    assert torch.equal(got[5], flt[5])
    want = eprop_update.rsnn_train_plain(*args, **kw, commit_grid=G)
    for g, p, f in zip(got[:3], want[:3], flt[:3]):
        err = float((g.double() - p.double()).abs().max()) * G.lsb
        assert err <= DW_TOL * float(f.abs().max()) + B * G.lsb
    for shards in (8, 4, B):
        assert torch.equal(_shard_sum(args, kw, shards), codes), shards


@pytest.mark.cuda
def test_sharded_methods_on_a_one_rank_nccl_world(cuda_device, tmp_path):
    """A one-rank NCCL world on the card: the backend's sharded launches
    (the public ops run a one-rank mesh unsharded) equal the unsharded
    launches bitwise, the collectives running on the card."""
    import torch.distributed as dist

    from repro_torch.core.backend import RuntimeConfig
    from repro_torch.core.quant import DW_COMMIT_SPEC
    from repro_torch.launch import mesh as meshlib

    meshlib.join_world(0, 1, f"file://{tmp_path / 'rendezvous'}", device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        mesh = meshlib.make_data_mesh(device="cuda")
        cfg, one, params, raster, valid, y_star = _train_case(
            np.random.default_rng(18), True, "symmetric", 64, 37, cuda_device)
        grid = RuntimeConfig(commit_grid=DW_COMMIT_SPEC)
        one_grid = ExecutionBackend(cfg, device=cuda_device, runtime=grid)
        sh = ExecutionBackend(cfg, device=cuda_device, runtime=RuntimeConfig(mesh=mesh))
        sh_grid = ExecutionBackend(cfg, device=cuda_device, runtime=RuntimeConfig(
            mesh=mesh, commit_grid=DW_COMMIT_SPEC))
        assert sh.num_devices == 1 and sh._group is not None
        carries = list(one.init_session_state(37).values())
        cases = [("_train", sh, one, (raster, y_star, valid)),
                 ("_train", sh_grid, one_grid, (raster, y_star, valid)),
                 ("_inference", sh, one, (raster, valid)),
                 ("_step_sessions", sh, one, (raster, valid, valid, carries))]
        for name, shard_be, ref_be, a in cases:
            got = getattr(shard_be, name)(params, *a, sharded=True)
            want = getattr(ref_be, name)(params, *a, sharded=False)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                for k in w:
                    assert torch.equal(g[k], w[k]), (name, k)
    finally:
        meshlib.leave_world()


# The backward's cases: GQA 4:1, 8:1, 3:1 and 1:1 (an odd G runs the dQ
# kernel with one head a block, an even G with two), ragged and
# single-row lengths (330 is no multiple of the 128-key dK/dV tile or the
# 64-key dQ tile), more queries than keys, non-causal, strided q, k, v
# with a non-contiguous dO
BWD_CASES = [
    (2, 200, 200, 16, 4, 128, True, False),
    (2, 256, 256, 8, 8, 64, True, False),
    (1, 130, 130, 8, 2, 128, False, True),
    (1, 1, 1, 4, 2, 32, True, False),
    (1, 70, 150, 4, 1, 16, False, False),
    (1, 150, 90, 4, 2, 64, True, True),
    (2, 1000, 1000, 32, 4, 128, True, False),
    (1, 330, 330, 6, 2, 128, True, False),
]
# Per gradient leaf, a bf16 train step through the kernels against the
# same step through the plain versions: max |Δg| <= LM_GRAD_TOL * max |g|.
# The two differ only in where attention's f32 sums round to bf16 (tile
# sizes, exp2 against exp): the plain version at two tile sizes differs
# by at most 0.0075 of a leaf's max |g| (reduced qwen3 in bf16, 2 layers,
# S=512: tests/_torch_lm_bf16_spread.py on a CPU); 2^-5 leaves room for
# that four times over.
LM_GRAD_TOL = 2 ** -5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,strided", BWD_CASES)
def test_flash_bwd_kernel_matches_plain_on_card(dtype, B, Sq, Skv, H, Hkv, D, causal,
                                                strided, cuda_device):
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(Sq * 5 + Skv)
    q, k, v = _flash_case(rng, B, Sq, Skv, H, Hkv, D, dtype, cuda_device, strided)
    do = torch.from_numpy(rng.normal(size=(B, H, Sq, D)).astype(np.float32)).to(
        cuda_device, dtype).transpose(1, 2)
    if not strided:
        do = do.contiguous()
    ops.reset_launch_counts()
    o, lse, o32 = FA.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(o, FA.flash_attention_cuda(q, k, v, causal=causal))
    _, plse, _ = FA.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-4)
    got = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=causal)
    again = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=causal)
    want = FA.flash_attention_bwd_plain(q, k, v, o32, lse, do, causal=causal)
    assert ops.launches["flash_attention_bwd"] == 2
    scale = max(float(w.float().abs().max()) for w in want)
    for name, g, a, w in zip("qkv", got, again, want):
        assert g.dtype == dtype and g.shape == w.shape and torch.isfinite(g).all(), name
        assert torch.equal(g, a), name
        if dtype == torch.float32:
            # a gradient zero in theory (dq and dk with one key: noise of
            # 1e-8 of the others) is held against the largest of the three
            ref = float(w.abs().max())
            err = float((g - w).abs().max()) / (ref if ref >= 1e-4 * scale else scale)
            assert err <= FLASH_F32_TOL, (name, err)
        else:
            assert FA.grad_row_error(g, w) <= FA.BWD_BF16_ROW_TOL, name


@pytest.mark.cuda
def test_flash_bwd_kernels_do_not_spill(cuda_device):
    """ptxas spills nothing in the bf16 backward's wgmma kernel at D=128
    (its dK/dV and dQ blocks, the dQ blocks with one and with two heads a
    block): the accumulators live in registers."""
    from repro_torch.kernels import build

    build.library()
    report = build.ptxas_report(build.ptxas_log())
    kernels = {k: v for k, v in report.items() if "flash_bwd_kernelILi128E" in k}
    assert len(kernels) == 2, sorted(report)
    for name, r in kernels.items():
        assert r["spill_stores"] == r["spill_loads"] == 0, (name, r)


@pytest.mark.cuda
def test_flash_bwd_gate_rejects_planted_faults(cuda_device):
    """dk x 0.9, and dk, dv without q tile 1's contributions."""
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(13)
    q, k, v = _flash_case(rng, 2, 512, 512, 8, 2, 128, torch.bfloat16, cuda_device,
                          False)
    do = torch.randn(q.shape, device=cuda_device).to(torch.bfloat16)
    _, lse, o32 = FA.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    got = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=True)
    want = FA.flash_attention_bwd_plain(q, k, v, o32, lse, do, causal=True)
    gate = lambda gs: max(FA.grad_row_error(g, w) for g, w in zip(gs, want))
    assert gate(got) <= FA.BWD_BF16_ROW_TOL
    assert gate((got[0], (got[1].float() * 0.9).to(torch.bfloat16), got[2])) > \
        FA.BWD_BF16_ROW_TOL
    cut = do.clone()
    cut[:, 64:128] = 0
    _, dk, dv = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, cut, causal=True)
    assert gate((got[0], dk, dv)) > FA.BWD_BF16_ROW_TOL


@pytest.mark.cuda
def test_lm_train_step_on_card_runs_the_kernels(cuda_device, monkeypatch):
    """One bf16 train step of the reduced qwen3 (D=16) on the card: under
    remat="full" the forward kernel runs twice a layer and the backward
    once; the gradients agree with the same step through the plain
    versions within LM_GRAD_TOL of each leaf's max |g|."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.train import build_run
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train.train_step import grads_of

    cfg = get_reduced("qwen3-1.7b").replace(dtype="bfloat16")
    run = build_run(cfg, steps=2, batch=4, seq=200, device=cuda_device)
    batch = next(run.stream)
    ops.reset_launch_counts()
    params, state = run.init_state()
    params, state, metrics = run.step_fn(params, state, batch)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == 2 * cfg.n_layers
    assert ops.launches["flash_attention_bwd"] == cfg.n_layers
    assert np.isfinite(float(metrics["loss"])) and int(state["step"]) == 1
    start, _ = run.init_state()
    kern, _ = grads_of(run.model, start, batch)
    monkeypatch.setattr(FA, "flash_attention_cuda", FA.flash_attention_plain)
    monkeypatch.setattr(FA, "flash_attention_bwd_cuda", FA.flash_attention_bwd_plain)
    ops.reset_launch_counts()
    plain, _ = grads_of(run.model, start, batch)
    assert ops.launches["flash_attention"] == ops.launches["flash_attention_bwd"] == 0
    for a, b in zip(tree_leaves(kern), tree_leaves(plain)):
        err = float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
        assert err <= LM_GRAD_TOL, err


@pytest.mark.cuda
def test_remat_modes_on_card_give_identical_gradients(cuda_device):
    """remat off, "full" and "dots" (selective checkpointing around the
    kernels) give the same gradient bits on the card; the forward kernel
    runs once a layer without remat and twice with it (attention is
    recomputed under "dots" too), the backward once."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.launch.train import build_run
    from repro_torch.models.model import build
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train.train_step import grads_of

    cfg = get_reduced("qwen3-1.7b").replace(dtype="bfloat16")
    run = build_run(cfg, steps=1, batch=2, seq=130, device=cuda_device)
    batch = next(run.stream)
    params, _ = run.init_state()
    grads = {}
    for remat, policy, fwd in [(False, "full", 1), (True, "full", 2), (True, "dots", 2)]:
        ops.reset_launch_counts()
        g, _ = grads_of(build(cfg.replace(remat=remat, remat_policy=policy)),
                        params, batch)
        torch.cuda.synchronize()
        assert ops.launches["flash_attention"] == fwd * cfg.n_layers, (remat, policy)
        assert ops.launches["flash_attention_bwd"] == cfg.n_layers
        grads[remat, policy] = tree_leaves(g)
    for key, g in grads.items():
        assert all(torch.equal(a, b) for a, b in zip(grads[False, "full"], g)), key


# ---------------------------------------------------------------------------
# MLA's (q/k, v) = (192, 128) pair and the MoE layer on the card
# ---------------------------------------------------------------------------


def _hopper_forward_checks(q, k, v, causal, kv_len, lse):
    """The bf16 forward (``flash_fwd_kernel``) against its plain version:
    each row within BF16_ROW_TOL, finite, two launches bitwise alike; with
    ``lse`` also lse within 1e-4, the f32 output per row within
    BF16_ROW_TOL and rounding to the bf16 output bit for bit, and the
    output bitwise the launch without lse."""
    from repro_torch.kernels import flash_attention as FA

    kw = dict(causal=causal, kv_len=kv_len)
    want, plse, p32 = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = FA.flash_attention_cuda(q, k, v, return_lse=lse, **kw)
    again = FA.flash_attention_cuda(q, k, v, return_lse=lse, **kw)
    o = got[0] if lse else got
    assert o.shape == want.shape and torch.isfinite(o).all()
    assert FA.row_error(o, want) <= FA.BF16_ROW_TOL
    for a, b in zip(got if lse else (got,), again if lse else (again,)):
        assert torch.equal(a, b)
    if lse:
        _, lse_t, o32 = got
        torch.testing.assert_close(lse_t, plse, rtol=0, atol=1e-4)
        assert FA.row_error(o32, p32) <= FA.BF16_ROW_TOL
        assert torch.equal(o, o32.to(torch.bfloat16))
        assert torch.equal(o, FA.flash_attention_cuda(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("DK,DV", [(16, 16), (32, 32), (64, 64), (128, 128), (192, 128)])
def test_flash_hopper_forward_every_width(DK, DV, causal, lse, cuda_device):
    """Every (q/k, v) width pair of KERNEL_HEAD_DIMS through the Hopper
    forward, causal and not, with and without lse: 200 queries (a ragged
    second 128-query tile) over 330 keys of which kv_len = 301 are filled
    (NaN in the tail, which the tensor maps end before), GQA 4:2, on
    head-major strided views."""
    rng = np.random.default_rng(DK * 7 + DV + causal)
    q, k, v = _flash_case(rng, 2, 200, 330, 4, 2, DK, torch.bfloat16, cuda_device, True, DV)
    k[:, 301:] = float("nan")
    v[:, 301:] = float("nan")
    ops.reset_launch_counts()
    _hopper_forward_checks(q, k, v, causal, 301, lse)
    assert ops.launches["flash_attention"] == 2 + lse


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 64, 65, 127])
@pytest.mark.parametrize("DK,DV", [(64, 64), (128, 128)])
def test_flash_hopper_forward_short_query_blocks(Sq, DK, DV, cuda_device):
    """Query counts that leave rows of a 128-query tile empty: one (a
    decode row; up to 64 queries the second consumer warpgroup exits at
    once) and 64, 65, 127 (not a multiple of 128), over a ragged 1,000-key
    memory with NaN past kv_len = 937, non-causal (cross-attention) and with
    lse."""
    rng = np.random.default_rng(Sq + DK)
    q, k, v = _flash_case(rng, 3, Sq, 1000, 8, 2, DK, torch.bfloat16, cuda_device, False, DV)
    k[:, 937:] = float("nan")
    v[:, 937:] = float("nan")
    _hopper_forward_checks(q, k, v, False, 937, True)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("DK,DV", [(128, 128), (192, 128)])
def test_flash_hopper_forward_persistent_blocks_take_many_tiles(DK, DV, causal,
                                                                cuda_device):
    """More tiles than SMs (2 x 16 heads x 12 q tiles of 128 = 384): each
    persistent block walks several q tiles with its k/v ring running on
    across them, heaviest first; every row within BF16_ROW_TOL, lse and
    the f32 output against the plain version, two launches bitwise."""
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(DK + causal)
    q, k, v = _flash_case(rng, 2, 1500, 1500, 16, 4, DK, torch.bfloat16, cuda_device, False,
                          DV)
    plan = FA.flash_plan(2, 1500, 16, DK, torch.bfloat16, DV,
                         torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    assert len(plan.tiles()) > plan.grid[0]
    _hopper_forward_checks(q, k, v, causal, None, True)


@pytest.mark.cuda
def test_flash_launch_refuses_a_plan_it_does_not_lay_out(cuda_device, monkeypatch):
    """The launcher checks the wrapper's plan against its own layout: a
    grid, a thread count or shared-memory bytes that are not the kernel's
    are refused before anything runs."""
    import dataclasses as dc

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.launch import KernelLaunchError

    q, k, v = _flash_case(np.random.default_rng(8), 1, 300, 300, 4, 2, 128, torch.bfloat16,
                          cuda_device, False)
    real = FA.flash_plan
    for bad in (lambda p: dc.replace(p, grid=(p.grid[0] + 1, 1)),
                lambda p: dc.replace(p, threads=256),
                lambda p: dc.replace(p, smem_bytes=p.smem_bytes + 16)):
        monkeypatch.setattr(FA, "flash_plan", lambda *a, bad=bad: bad(real(*a)))
        ops.reset_launch_counts()
        with pytest.raises(KernelLaunchError):
            FA.flash_attention_cuda(q, k, v, causal=True)
        assert ops.launches["flash_attention"] == 0


@pytest.mark.cuda
def test_flash_fwd_kernels_do_not_spill(cuda_device):
    """ptxas spills nothing in the bf16 forward's wgmma kernel at any width
    pair, with and without lse: the output and score accumulators live in
    registers."""
    from repro_torch.kernels import build

    build.library()
    report = build.ptxas_report(build.ptxas_log())
    kernels = {k: v for k, v in report.items() if "flash_fwd_kernel" in k}
    assert len(kernels) == 10, sorted(report)
    for name, r in kernels.items():
        assert r["spill_stores"] == r["spill_loads"] == 0, (name, r)


def _mla_case(rng, B, Sq, Skv, H, dev, strided, DK=192, DV=128):
    """q (B, Sq, H, DK), k (B, Skv, H, DK), v (B, Skv, H, DV) in bf16 (MLA has
    as many KV heads as heads); ``strided`` makes them views of head-major
    tensors."""
    def one(S, D):
        x = rng.normal(size=(B, H, S, D) if strided else (B, S, H, D)) * 0.3
        x = torch.from_numpy(x.astype(np.float32)).to(dev, torch.bfloat16)
        return x.transpose(1, 2) if strided else x
    return one(Sq, DK), one(Skv, DK), one(Skv, DV)


# ragged lengths (no multiple of the 128-query forward tiles, the 128-key
# dK/dV tiles or the 32-query q tiles), a single row, more keys than
# queries, non-causal, strided views with a non-contiguous dO
MLA_CASES = [
    (2, 200, 200, 4, True, False),
    (1, 330, 330, 3, True, False),
    (1, 1, 1, 2, True, False),
    (1, 100, 260, 4, False, True),
    (2, 517, 517, 2, True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,causal,strided", MLA_CASES)
def test_mla_flash_kernels_match_plain_on_card(B, Sq, Skv, H, causal, strided,
                                               cuda_device):
    """The forward (with and without lse) and the backward at (192, 128)
    against their plain versions: the forward per row within BF16_ROW_TOL,
    lse within 1e-4, dq and dk 192 wide and dv 128 wide per row within
    BWD_BF16_ROW_TOL; two launches of each give the same bits."""
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(Sq * 3 + Skv)
    q, k, v = _mla_case(rng, B, Sq, Skv, H, cuda_device, strided)
    do = torch.from_numpy(rng.normal(size=(B, H, Sq, 128)).astype(np.float32)).to(
        cuda_device, torch.bfloat16).transpose(1, 2)
    if not strided:
        do = do.contiguous()
    ops.reset_launch_counts()
    o, lse, o32 = FA.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    assert o.shape == (B, Sq, H, 128)
    assert torch.equal(o, FA.flash_attention_cuda(q, k, v, causal=causal))
    want_o, plse, _ = FA.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    assert FA.row_error(o, want_o) <= FA.BF16_ROW_TOL
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-4)
    if Sq == Skv:
        got = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=causal)
        again = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=causal)
        want = FA.flash_attention_bwd_plain(q, k, v, o32, lse, do, causal=causal)
        assert ops.launches["flash_attention_bwd"] == 2
        for name, g, a, w in zip("qkv", got, again, want):
            assert g.shape == w.shape and torch.isfinite(g).all(), name
            assert torch.equal(g, a), name
            assert FA.grad_row_error(g, w) <= FA.BWD_BF16_ROW_TOL, name
        assert got[0].shape[-1] == got[1].shape[-1] == 192 and got[2].shape[-1] == 128
    assert ops.launches["flash_attention"] == 2


@pytest.mark.cuda
def test_mla_pair_refusals_on_card(cuda_device):
    """The pair runs in bf16 only: an f32 call at (192, 128) raises naming
    the pair, as does a pair no kernel is instantiated for; nothing
    launches and nothing falls back to the plain version."""
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(4)
    q, k, v = _mla_case(rng, 1, 64, 64, 2, cuda_device, False)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=r"\(192, 128\)"):
        FA.flash_attention_cuda(q.float(), k.float(), v.float(), causal=True)
    o, lse, _ = FA.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    with pytest.raises(ValueError, match=r"\(192, 128\)"):
        FA.flash_attention_bwd_cuda(q.float(), k.float(), v.float(), o.float(), lse,
                                    o.float(), causal=True)
    for dk, dv in ((192, 64), (128, 64), (96, 96)):
        a, b, c = _mla_case(rng, 1, 64, 64, 2, cuda_device, False, dk, dv)
        with pytest.raises(ValueError, match=rf"\({dk}, {dv}\)"):
            FA.flash_attention_cuda(a, b, c, causal=True)
    assert ops.launches["flash_attention"] == 1
    assert ops.launches["flash_attention_bwd"] == 0


@pytest.mark.cuda
def test_mla_kernels_report_registers(cuda_device):
    """ptxas reports the (192, 128) instantiations of the forward (with and
    without lse) and of the backward (one head a dQ block)."""
    from repro_torch.kernels import build

    build.library()
    report = build.ptxas_report(build.ptxas_log())
    names = [k for k in report if "ILi192ELi128E" in k]
    assert sum("flash_fwd_kernel" in k for k in names) == 2, sorted(report)
    assert any("flash_bwd_kernel" in k for k in names), sorted(report)
    assert any("flash_bwd_delta_bf16_kernel" in k for k in report), sorted(report)


def _mla_reduced(**moe):
    """The reduced deepseek in bf16 with MLA's widths raised to the card
    pair's (nope 128, rope 64, v 128), capacity raised until nothing drops
    (so the kernel and the plain paths route the same tokens alike)."""
    import dataclasses as dc

    from repro_torch.configs.base import MLAConfig, get_reduced

    cfg = get_reduced("deepseek-v2-lite-16b")
    return cfg.replace(dtype="bfloat16", d_head=192,
                       mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=128, qk_rope_dim=64,
                                     v_head_dim=128),
                       moe=dc.replace(cfg.moe, **moe))


@pytest.mark.cuda
def test_moe_forward_repeats_bitwise_on_card(cuda_device):
    """The combine sums each token's k rows in a fixed order (no atomics):
    two calls give the same bits, forward and gradients."""
    from repro_torch.models import moe
    from repro_torch.models.model import build

    cfg = _mla_reduced()
    params = build(cfg).init(3, device=cuda_device)
    from repro_torch.models.transformer import tree_map

    p = tree_map(lambda t: t[0], params["layers"]["scan"]["0"]["ffn"])  # layer 1
    x = torch.randn((4, 300, cfg.d_model), device=cuda_device).to(torch.bfloat16)
    outs = []
    for _ in range(2):
        xg = x.clone().requires_grad_()
        y, aux = moe.moe_forward(p, xg, cfg)
        (g,) = torch.autograd.grad((y.float().square().sum() + aux), xg)
        outs.append((y, aux, g))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_reduced_mla_model_on_card_runs_the_kernels(cuda_device, monkeypatch):
    """A reduced MLA model at the card's pair: its prefill launches the
    forward kernel once a layer and agrees with a prefill through the plain
    version under the same routing (within 2^-5 of the largest logit: a
    few bf16 roundings), and one train step launches the forward twice and
    the backward once a layer, its gradients within LM_GRAD_TOL of the
    plain versions' per leaf."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.model import build
    from repro_torch.models.moe import pinned_routing
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train.train_step import grads_of

    cfg = _mla_reduced(capacity_factor=64.0)
    model = build(cfg)
    params = model.init(5, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 161)))
    toks = toks.to(cuda_device)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    # the two runs route alike (pinned_routing): a token whose router
    # probabilities nearly tie may otherwise pick another expert in one
    # of them, which moves its output by that expert's share
    with pinned_routing() as pin:
        ops.reset_launch_counts()
        logits, _ = model.prefill(params, batch)
        assert ops.launches["flash_attention"] == cfg.n_layers
        ops.reset_launch_counts()
        kern, _ = grads_of(model, params, batch)
        assert ops.launches["flash_attention"] == 2 * cfg.n_layers
        assert ops.launches["flash_attention_bwd"] == cfg.n_layers
        monkeypatch.setattr(FA, "flash_attention_cuda", FA.flash_attention_plain)
        monkeypatch.setattr(FA, "flash_attention_bwd_cuda", FA.flash_attention_bwd_plain)
        pin.replay()
        plain_logits, _ = model.prefill(params, batch)
        plain, _ = grads_of(model, params, batch)
    assert float((logits.float() - plain_logits.float()).abs().max()) <= \
        2 ** -5 * float(plain_logits.float().abs().max())
    for a, b in zip(tree_leaves(kern), tree_leaves(plain)):
        err = float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
        assert err <= LM_GRAD_TOL, err


# ---------------------------------------------------------------------------
# the ssm and hybrid families (Mamba2's SSD; jamba's period) on the card
# ---------------------------------------------------------------------------


def _ssm_reduced(arch, **kw):
    """A reduced ssm or hybrid arch, jamba at a capacity where nothing
    drops."""
    import dataclasses as dc

    from repro_torch.configs.base import get_reduced

    cfg = get_reduced(arch).replace(**kw)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dc.replace(cfg.moe, capacity_factor=64.0))
    return cfg


def _rel_err(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_reduced_ssm_models_on_card_match_the_cpu(arch, cuda_device):
    """The reduced arch in f32 (TF32 off): prefill logits and every cache
    leaf, one decode step, and ``train_loss`` with its gradients on the
    card within 1e-4 of each tensor's max of the same on the CPU (f32 sums
    in another order; jamba's attention through the flash kernels, its
    routing replayed from the CPU run)."""
    from repro_torch.models.model import build
    from repro_torch.models.moe import pinned_routing
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.train.train_step import grads_of

    cfg = _ssm_reduced(arch)
    model = build(cfg)
    cpu = model.init(2, device="cpu")
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 41)))
    B, L = 2, 40
    out = {}
    with pinned_routing() as pin:
        for dev, params in (("cpu", cpu), (cuda_device, card)):
            t = toks.to(dev)
            logits, caches = model.prefill(params, {"tokens": t[:, :L]},
                                           model.init_cache(B, L + 4, device=dev))
            dec, _ = model.decode_step(params, caches, t[:, L:], L)
            grads, m = grads_of(model, params, {"tokens": t[:, :L], "targets": t[:, 1:]})
            out[str(dev)] = (logits, tree_leaves(caches), dec, m["loss"], tree_leaves(grads))
            pin.replay([c.to(cuda_device) for c in pin.log])
    (l0, c0, d0, loss0, g0), (l1, c1, d1, loss1, g1) = out["cpu"], out[str(cuda_device)]
    assert _rel_err(l1, l0) <= 1e-4 and _rel_err(d1, d0) <= 1e-4
    assert abs(float(loss1) - float(loss0)) <= 1e-4 * abs(float(loss0))
    for a, b in zip(c1, c0):
        assert a.dtype == b.dtype and _rel_err(a, b) <= 1e-4
    for a, b in zip(g1, g0):
        assert _rel_err(a, b) <= 1e-4


@pytest.mark.cuda
def test_reduced_jamba_train_step_on_card_runs_the_kernels(cuda_device):
    """One bf16 train step of the reduced jamba: its one attention layer
    launches the forward kernel twice (remat="full" runs the period's
    forward again) and the backward once; the loss and grad norm are
    finite."""
    from repro_torch.launch.train import build_run

    cfg = _ssm_reduced("jamba-v0.1-52b", dtype="bfloat16")
    run = build_run(cfg, steps=2, batch=4, seq=200, device=cuda_device)
    batch = next(run.stream)
    params, state = run.init_state()
    ops.reset_launch_counts()
    params, state, metrics = run.step_fn(params, state, batch)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == 2 and ops.launches["flash_attention_bwd"] == 1
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))


@pytest.mark.cuda
def test_planted_large_dt_gives_finite_gradients_on_card(cuda_device):
    """The reduced mamba2 in bf16 with 64-step chunks and every dt_bias at
    4 (dt near 4: a chunk's decay sum near 256, past the f32 exp's 88.7):
    the within-chunk decay is masked before its exp, so every gradient is
    finite."""
    import dataclasses as dc

    from repro_torch.models.model import build
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train.train_step import grads_of

    cfg = _ssm_reduced("mamba2-1.3b", dtype="bfloat16")
    cfg = cfg.replace(ssm=dc.replace(cfg.ssm, chunk=64))
    model = build(cfg)
    params = model.init(1, device=cuda_device)
    mixer = params["layers"]["scan"]["0"]["mixer"]
    mixer["dt_bias"] = torch.full_like(mixer["dt_bias"], 4.0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 129)))
    toks = toks.to(cuda_device)
    grads, m = grads_of(model, params, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    assert np.isfinite(float(m["loss"]))
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


# ---------------------------------------------------------------------------
# cross-attention and the encoder (the vlm and audio families) on the card
# ---------------------------------------------------------------------------


# Non-causal, Sq != Skv: llama-3.2-vision's cross-attention (G=8 over a
# ragged 1,600-key memory: 12 whole 128-key tiles of the forward and of
# the dK/dV blocks, and a ragged 13th) and seamless's decoder over an
# encoder memory (D=64, MHA, ragged both ways); then decode's one query
# row against the 1,600 media keys at G=8 (one live row of a 128-query
# tile)
CROSS_CASES = [
    (2, 300, 1600, 16, 2, 128),
    (2, 257, 1000, 4, 4, 64),
    (1, 1, 1600, 64, 8, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D", CROSS_CASES)
def test_flash_kernels_at_cross_attention_shapes(dtype, B, Sq, Skv, H, Hkv, D,
                                                 cuda_device):
    """The forward (``ops.flash_attention``, as the model calls it) and the
    backward at cross-attention's shapes against their plain versions, at
    the tolerances of the tests above; the backward of the decode row is
    not on any path and is not run."""
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(Sq * 3 + Skv)
    q, k, v = _flash_case(rng, B, Sq, Skv, H, Hkv, D, dtype, cuda_device, False)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=False)
    want = FA.flash_attention_plain(q, k, v, causal=False)
    assert ops.launches["flash_attention"] == 1 and got.shape == (B, Sq, H, D)
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) / float(want.abs().max()) <= FLASH_F32_TOL
    else:
        assert FA.row_error(got, want) <= FA.BF16_ROW_TOL
    if Sq == 1:
        return
    do = torch.from_numpy(rng.normal(size=(B, Sq, H, D)).astype(np.float32)).to(
        cuda_device, dtype)
    _, lse, o32 = FA.flash_attention_cuda(q, k, v, causal=False, return_lse=True)
    grads = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=False)
    want = FA.flash_attention_bwd_plain(q, k, v, o32, lse, do, causal=False)
    assert ops.launches["flash_attention_bwd"] == 1
    for name, g, w in zip("qkv", grads, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        if dtype == torch.float32:
            err = float((g - w).abs().max()) / float(w.abs().max())
            assert err <= FLASH_F32_TOL, (name, err)
        else:
            assert FA.grad_row_error(g, w) <= FA.BWD_BF16_ROW_TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "seamless-m4t-large-v2"])
def test_reduced_xattn_train_step_on_card_runs_the_kernels(arch, cuda_device,
                                                           monkeypatch):
    """One bf16 train step of the reduced vlm (one cross-attention layer,
    four self-attention layers) or encoder-decoder (two encoder layers,
    two decoder layers of self- and cross-attention): under remat="full"
    the forward kernel runs twice an attention and the backward once; the
    gradients, the encoder's included, agree with the same step through
    the plain versions within LM_GRAD_TOL of each leaf's max |g|."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.train import build_run
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train.train_step import grads_of

    cfg = get_reduced(arch).replace(dtype="bfloat16")
    n_attn = cfg.n_layers + (cfg.n_layers + cfg.n_enc_layers if cfg.encdec else 0)
    run = build_run(cfg, steps=2, batch=4, seq=200, device=cuda_device)
    batch = next(run.stream)
    ops.reset_launch_counts()
    params, state = run.init_state()
    params, state, metrics = run.step_fn(params, state, batch)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == 2 * n_attn
    assert ops.launches["flash_attention_bwd"] == n_attn
    assert np.isfinite(float(metrics["loss"])) and int(state["step"]) == 1
    start, _ = run.init_state()
    kern, _ = grads_of(run.model, start, batch)
    monkeypatch.setattr(FA, "flash_attention_cuda", FA.flash_attention_plain)
    monkeypatch.setattr(FA, "flash_attention_bwd_cuda", FA.flash_attention_bwd_plain)
    ops.reset_launch_counts()
    plain, _ = grads_of(run.model, start, batch)
    assert ops.launches["flash_attention"] == ops.launches["flash_attention_bwd"] == 0
    for a, b in zip(tree_leaves(kern), tree_leaves(plain)):
        err = float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
        assert err <= LM_GRAD_TOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "seamless-m4t-large-v2"])
def test_reduced_xattn_models_on_card_match_the_cpu(arch, cuda_device):
    """The reduced arch in f32 (TF32 off): prefill logits and every cache
    leaf, one decode step (its cross-attention one query row through the
    forward kernel) and ``train_loss`` with its gradients on the card
    within 1e-4 of each tensor's max of the same on the CPU."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.models.model import build
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.train.train_step import grads_of

    cfg = get_reduced(arch)
    model = build(cfg)
    cpu = model.init(2, device="cpu")
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    rng = np.random.default_rng(4)
    B, L = 2, 40
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, L + 1)))
    key, n = (("media", cfg.n_media_tokens) if cfg.family == "vlm"
              else ("src_embeds", cfg.enc_seq))
    mem = torch.from_numpy((rng.standard_normal((B, n, cfg.d_model)) * 0.02)
                           .astype(np.float32))
    out = {}
    for dev, params in (("cpu", cpu), (cuda_device, card)):
        t, m = toks.to(dev), mem.to(dev)
        ops.reset_launch_counts()
        logits, caches = model.prefill(params, {"tokens": t[:, :L], key: m},
                                       model.init_cache(B, L + 4, device=dev))
        dec, _ = model.decode_step(params, caches, t[:, L:], L)
        if dev != "cpu":   # the prefill's attentions, then decode's cross rows
            torch.cuda.synchronize()
            kinds = model.plan.period * model.plan.repeats
            n_self = sum(k[0] in ("attn", "attn_xattn") for k in kinds)
            n_cross = sum(k[0] in ("xattn", "attn_xattn") for k in kinds)
            assert ops.launches["flash_attention"] == (cfg.n_enc_layers + n_self
                                                       + 2 * n_cross)
        grads, met = grads_of(model, params, {"tokens": t[:, :L], "targets": t[:, 1:],
                                              key: m})
        out[str(dev)] = (logits, tree_leaves(caches), dec, met["loss"], tree_leaves(grads))
    (l0, c0, d0, loss0, g0), (l1, c1, d1, loss1, g1) = out["cpu"], out[str(cuda_device)]
    assert _rel_err(l1, l0) <= 1e-4 and _rel_err(d1, d0) <= 1e-4
    assert abs(float(loss1) - float(loss0)) <= 1e-4 * abs(float(loss0))
    for a, b in zip(c1, c0):
        assert a.dtype == b.dtype and _rel_err(a, b) <= 1e-4
    for a, b in zip(g1, g0):
        assert _rel_err(a, b) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D", [(2, 300, 1600, 16, 2, 128),
                                              (2, 257, 1000, 4, 4, 64),
                                              (2, 200, 200, 4, 4, 192)])
def test_flash_forward_unrounded_output_on_card(B, Sq, Skv, H, Hkv, D, cuda_device):
    """The bf16 forward with lse also writes its output before the rounding
    (the training path's; the backward takes δ from it): the output is it
    rounded, bit for bit, and is the launch without lse's, and it lies
    within BF16_ROW_TOL of the plain version's per row; (192, 128) at MLA's
    widths."""
    from repro_torch.kernels import flash_attention as FA

    DV = 128 if D == 192 else D
    rng = np.random.default_rng(Sq + Skv + D)
    q, k, _ = _flash_case(rng, B, Sq, Skv, H, Hkv, D, torch.bfloat16, cuda_device, False)
    v = torch.from_numpy((rng.normal(size=(B, Skv, Hkv, DV)) * 0.3).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    causal = D == 192
    o, lse, o32 = FA.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    _, _, want = FA.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    assert o32.dtype == torch.float32 and o32.shape == (B, Sq, H, DV)
    assert torch.equal(o, o32.to(torch.bfloat16))
    assert torch.equal(o, FA.flash_attention_cuda(q, k, v, causal=causal))
    assert FA.row_error(o32, want) <= FA.BF16_ROW_TOL


@pytest.mark.cuda
def test_flash_bwd_delta_from_unrounded_output_on_card(cuda_device):
    """Keys and values that share a large part (a cross-attention's memory
    does): dq cancels, and δ from the rounded output leads it.  Given the
    forward's f32 output, the backward kernel's dq lies within twice the
    plain version's distance from the f32 gradient (its operands rounded as
    the kernel's are), and given the rounded output (as f32) more than 5
    times its own distance away (tests/test_torch_xattn.py measures 12-14
    times on a CPU); dk and dv agree with the plain version's per row
    within BWD_BF16_ROW_TOL."""
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(0)
    B, Sq, Skv, H, Hkv, D = 2, 256, 1600, 16, 2, 128
    shared_k, shared_v = rng.normal(size=(2, 1, 1, Hkv, D))
    make = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device, torch.bfloat16)
    q = make(rng.normal(size=(B, Sq, H, D)))
    k = make(shared_k + 0.3 * rng.normal(size=(B, Skv, Hkv, D)))
    v = make(shared_v + 0.3 * rng.normal(size=(B, Skv, Hkv, D)))
    do = make(rng.normal(size=(B, Sq, H, D)))
    o, lse, o32 = FA.flash_attention_cuda(q, k, v, causal=False, return_lse=True)
    ops.reset_launch_counts()
    kern = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=False)
    rounded = FA.flash_attention_bwd_cuda(q, k, v, o.float(), lse, do, causal=False)
    assert ops.launches["flash_attention_bwd"] == 2
    plain = FA.flash_attention_bwd_plain(q, k, v, o32, lse, do, causal=False)
    f32 = [t.float() for t in (q, k, v, do)]
    _, lse_f, o_f = FA.flash_attention_plain(*f32[:3], causal=False, return_lse=True)
    want = FA.flash_attention_bwd_plain(*f32[:3], o_f, lse_f, f32[3], causal=False)[0]
    err = lambda g: float((g.float() - want).abs().max()) / float(want.abs().max())
    assert err(kern[0]) <= 2 * err(plain[0])
    assert err(rounded[0]) > 5 * err(kern[0])
    for g, w in zip(kern[1:], plain[1:]):
        assert FA.grad_row_error(g, w) <= FA.BWD_BF16_ROW_TOL


@pytest.mark.cuda
def test_compressed_mean_on_a_one_rank_nccl_world(cuda_device, tmp_path):
    """int8 error feedback over a one-rank NCCL pod axis: each leaf's mean
    is deq(quant(g + r)) in the gradient's dtype and its residual g + r -
    deq, bitwise, as the same arithmetic on the CPU gives it; a bf16
    leaf's mean stays bf16."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as meshlib
    from repro_torch.optim import compression as C

    rng = np.random.default_rng(25)
    g = {"w": torch.from_numpy(rng.normal(size=(257, 33)).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32)).to(torch.bfloat16),
         "z": torch.zeros(16)}
    r = {k: torch.from_numpy((rng.normal(size=v.shape) * 0.01).astype(np.float32))
         for k, v in g.items()}
    meshlib.join_world(0, 1, f"file://{tmp_path / 'rendezvous'}", device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        group = meshlib.make_debug_mesh(1, 1, n_pod=1).get_group("pod")
        mean, res = C.compressed_psum_mean({k: v.to(cuda_device) for k, v in g.items()},
                                           {k: v.to(cuda_device) for k, v in r.items()}, group)
        torch.cuda.synchronize()
    finally:
        meshlib.leave_world()
    for k in g:
        g32 = g[k].float() + r[k]
        q, s = C.quantize_int8(g32)
        deq = C.dequantize_int8(q, s)
        assert mean[k].dtype == g[k].dtype and mean[k].is_cuda
        assert torch.equal(mean[k].cpu(), deq.to(g[k].dtype)), k
        assert torch.equal(res[k].cpu(), g32 - deq), k


@pytest.mark.cuda
def test_gpipe_on_a_one_rank_nccl_world(cuda_device, tmp_path):
    """GPipe at one stage on the card: bitwise ``reference_pipeline``."""
    from repro_torch.distributed.pipeline import gpipe, reference_pipeline
    from repro_torch.launch import mesh as meshlib

    rng = np.random.default_rng(26)
    params = {"w": torch.from_numpy((rng.normal(size=(1, 64, 64)) * 0.2).astype(
        np.float32)).to(cuda_device)}
    x = torch.from_numpy(rng.normal(size=(5, 3, 64)).astype(np.float32)).to(cuda_device)
    fn = lambda p, xb: torch.tanh(xb @ p["w"])
    meshlib.join_world(0, 1, f"file://{tmp_path / 'rendezvous'}", device="cuda")
    try:
        out = gpipe(fn, params, x, mesh=meshlib.make_debug_mesh(1, 1, n_pod=1), axis="pod")
    finally:
        meshlib.leave_world()
    assert out.is_cuda and torch.equal(out, reference_pipeline(fn, params, x))


@pytest.mark.cuda
def test_sharded_step_on_a_one_rank_nccl_world_is_the_unsharded_step(cuda_device, tmp_path):
    """qwen3-1.7b at a reduced width in bf16: two sharded (FSDP x TP) steps
    over a (data, model) = 1 x 1 mesh under ``use_mesh`` (DTensor state,
    the flash kernels on the local shards, launched as often as the
    unsharded step launches them) give the unsharded steps' losses and
    parameters bitwise."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.train import build_run
    from repro_torch.models.transformer import tree_leaves

    cfg = get_reduced("qwen3-1.7b").replace(dtype="bfloat16", d_model=256, d_head=64,
                                            d_ff=512, vocab=1024)
    meshlib.join_world(0, 1, f"file://{tmp_path / 'rendezvous'}", device="cuda")
    try:
        mesh = meshlib.make_debug_mesh(1, 1)
        runs = [build_run(cfg, steps=2, batch=2, seq=256, device=cuda_device, mesh=m)
                for m in (None, mesh)]
        batches = [next(runs[0].stream) for _ in range(2)]
        out = []
        for run in runs:
            params, state = run.init_state()
            ops.reset_launch_counts()
            losses = []
            for b in batches:
                params, state, metrics = run.step_fn(params, state, b)
                losses.append(float(metrics["loss"]))
            out.append((losses, [(t.full_tensor() if hasattr(t, "full_tensor") else t)
                                 for t in tree_leaves(params)], dict(ops.launches)))
    finally:
        meshlib.leave_world()
    (l0, p0, n0), (l1, p1, n1) = out
    assert n1["flash_attention"] == n0["flash_attention"] > 0
    assert n1["flash_attention_bwd"] == n0["flash_attention_bwd"] > 0
    assert l1 == l0
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(p1, p0))


@pytest.mark.cuda
def test_expert_parallel_prefill_on_a_one_rank_nccl_world_is_the_plain_path(
        cuda_device, tmp_path):
    """phi3.5-moe reduced in bf16: a prefill with ``use_shard_map`` over a
    ``model`` = 1 mesh runs expert parallelism in every layer (the parts
    summed over ``model`` in f32) and gives the plain path's logits
    bitwise."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import moe
    from repro_torch.models.model import build

    cfg = get_reduced("phi3.5-moe-42b-a6.6b").replace(dtype="bfloat16")
    ep_cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, use_shard_map=True))
    params = build(cfg).init(3, device=cuda_device)
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=cuda_device,
                           generator=torch.Generator(device=cuda_device).manual_seed(4))
    taken, real = [], moe._moe_expert_parallel
    moe._moe_expert_parallel = lambda *a: taken.append(1) or real(*a)
    meshlib.join_world(0, 1, f"file://{tmp_path / 'rendezvous'}", device="cuda")
    try:
        plain, _ = build(cfg).prefill(params, {"tokens": tokens})
        with use_mesh(meshlib.make_debug_mesh(1, 1)):
            ep, _ = build(ep_cfg).prefill(params, {"tokens": tokens})
    finally:
        meshlib.leave_world()
        moe._moe_expert_parallel = real
    assert len(taken) == cfg.n_layers
    assert torch.equal(ep.view(torch.int16), plain.view(torch.int16))


# ---------------------------------------------------------------------------
# the flash launches as operators (the dry run's fake implementations)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,DV", [
    (2, 200, 200, 8, 2, 64, 64), (1, 1, 96, 4, 4, 128, 128), (2, 130, 130, 4, 4, 192, 128)])
def test_flash_operators_fake_shapes_are_the_launches(dtype, B, Sq, Skv, H, Hkv, D, DV,
                                                      cuda_device):
    """Each operator's fake outputs (FakeTensorMode, the dry run) have the
    real launch's shapes and dtypes; one real call adds exactly one to its
    kernel's launch counter, a fake call none."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as FA

    if dtype == torch.float32 and D != DV:
        pytest.skip("(192, 128) runs in bf16 only")
    g = torch.Generator(device=cuda_device).manual_seed(3)
    mk = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(dtype)
    q, k, v = mk(B, Sq, H, D), mk(B, Skv, Hkv, D), mk(B, Skv, Hkv, DV)
    causal = Sq == Skv
    sig = lambda ts: [(tuple(t.shape), t.dtype, t.device.type) for t in ts]

    def calls(q, k, v):
        o = torch.ops.repro_torch.flash_attention(q, k, v, causal, None)
        o_l, lse, o32 = torch.ops.repro_torch.flash_attention_lse(q, k, v, causal)
        do = o_l.clone()
        grads = (torch.ops.repro_torch.flash_attention_bwd(q, k, v, o_l if o32.numel() == 0
                                                           else o32, lse, do, causal)
                 if causal else ())
        return [o], [o_l, lse, o32], list(grads)

    ops.reset_launch_counts()
    real = calls(q, k, v)
    torch.cuda.synchronize()
    n_bwd = 1 if causal else 0
    assert ops.launches["flash_attention"] == 2
    assert ops.launches["flash_attention_bwd"] == n_bwd
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        fake = calls(fq, fk, fv)
    assert ops.launches["flash_attention"] == 2 and ops.launches["flash_attention_bwd"] == n_bwd
    for r, f in zip(real, fake):
        assert sig(r) == sig(f)


@pytest.mark.cuda
def test_flash_operator_on_a_real_tensor_launches_never_the_fake(cuda_device, monkeypatch):
    """A real CUDA tensor goes to the launcher, never to the fake
    implementation (whose checks run with ``data`` off), and a refused
    launch raises; a CPU tensor has no implementation of the operator."""
    from repro_torch.kernels import flash_attention as FA

    checks = []
    real_check = FA._check_card_inputs

    def spy(op, q, k, v, *, data=True):
        checks.append(data)
        return real_check(op, q, k, v, data=data)

    monkeypatch.setattr(FA, "_check_card_inputs", spy)
    q = torch.randn(1, 64, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    ops.flash_attention(q, q, q, causal=True)
    torch.ops.repro_torch.flash_attention_lse(q, q, q, True)
    torch.cuda.synchronize()
    assert checks == [True, True] and ops.launches["flash_attention"] == 2
    with pytest.raises(ValueError, match="head widths"):
        torch.ops.repro_torch.flash_attention(q[..., :8], q[..., :8], q[..., :8], True, None)
    assert checks[-1] is True and ops.launches["flash_attention"] == 2
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.flash_attention(q.cpu(), q.cpu(), q.cpu(), True, None)
