"""The port's serving kernels against the JAX package's Pallas kernels.

On the CPU the port's ops run the kernels' plain PyTorch versions; the JAX
kernels run as the JAX package's own tests run them (``ExecutionBackend(cfg,
"kernel")``, Pallas in interpret mode).  Inputs and weights are made with
numpy from a seed and handed to both packages (weights through
``params_from_jax``).  Quantized mode is held bitwise; float mode to
``atol = rtol = 1e-4`` (CPU matmul reduction orders differ between XLA
and PyTorch).  Kept at T <= 32 and B <= 8: interpret mode is slow.
"""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import ExecutionBackend as JaxBackend
from repro.core.rsnn import Presets as JaxPresets
from repro_torch.convert import params_from_jax
from repro_torch.core.backend import ExecutionBackend
from repro_torch.core.rsnn import Presets
from repro_torch.kernels import ops, rsnn_step

FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)


# JAX kernel VMEM budget that cuts a Braille-width batch into 3-row tiles,
# so B = 8 ends in a ragged (2-row, zero-padded) last tile.
RAGGED_VMEM = 8056 + 3 * 2404


def _weights(rng, n_in, n_hid, n_out, gain):
    return {
        "w_in": gain * rng.normal(size=(n_in, n_hid)) / np.sqrt(n_in),
        "w_rec": gain * rng.normal(size=(n_hid, n_hid)) / np.sqrt(n_hid),
        "w_out": gain * rng.normal(size=(n_hid, n_out)) / np.sqrt(n_hid),
    }


def _tile(seed, T, B, quantized, label_delay=0, density=0.3, gain=2.5):
    rng = np.random.default_rng(seed)
    jcfg = JaxPresets.braille(num_ticks=T, quantized=quantized,
                              label_delay=label_delay)
    tcfg = Presets.braille(num_ticks=T, quantized=quantized,
                           label_delay=label_delay)
    w = {k: v.astype(np.float32)
         for k, v in _weights(rng, tcfg.n_in, tcfg.n_hid, tcfg.n_out, gain).items()}
    raster = (rng.random((T, B, tcfg.n_in)) < density).astype(np.float32)
    label_tick = rng.integers(0, T // 2, size=B)
    end_tick = rng.integers(T // 2, T, size=B)
    t = np.arange(T)[:, None]
    valid = ((t >= label_tick + label_delay) & (t <= end_tick)).astype(np.float32)
    return jcfg, tcfg, w, raster, valid, rng


def _check(a, b, quantized):
    a, b = np.asarray(a), np.asarray(b)
    if quantized:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, **FLOAT_TOL)


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("B,vmem", [(8, RAGGED_VMEM), (1, None)])
def test_infer_plain_matches_jax_kernel(quantized, B, vmem):
    jcfg, tcfg, w, raster, valid, _ = _tile(1, 32, B, quantized, label_delay=3)
    jout = JaxBackend(jcfg, "kernel", vmem_budget=vmem).inference(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(raster),
        jnp.asarray(valid))
    be = ExecutionBackend(tcfg, device="cpu")
    tout = be.inference(params_from_jax(w, device="cpu"),
                        torch.from_numpy(raster), torch.from_numpy(valid))
    _check(jout["acc_y"], tout["acc_y"], quantized)
    np.testing.assert_array_equal(np.asarray(jout["pred"]), tout["pred"].numpy())
    np.testing.assert_allclose(float(jout["spike_rate"]),
                               float(tout["spike_rate"]), rtol=1e-6)
    if quantized:
        assert float(tout["spike_rate"]) > 0   # the datapath really fires


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("infer_window", ["valid", "all"])
def test_step_sessions_plain_matches_jax_kernel(quantized, infer_window):
    """Carries in from a previous chunk, dead ``live`` rows and holes,
    ragged last tile, ``label_delay > 0``."""
    T, B = 24, 8
    jcfg, tcfg, w, raster, valid, rng = _tile(2, T, B, quantized, label_delay=2)
    eco = dict(infer_window=infer_window)
    jcfg = dataclasses.replace(jcfg, eprop=dataclasses.replace(jcfg.eprop, **eco))
    tcfg = dataclasses.replace(tcfg, eprop=dataclasses.replace(tcfg.eprop, **eco))
    n_live = rng.integers(0, T + 1, size=B)
    n_live[3] = 0                                     # a dead row
    live = (np.arange(T)[:, None] < n_live).astype(np.float32)
    live[5:9, 1] = 0.0                                # a hole mid-chunk
    valid = valid * live
    H, O = tcfg.n_hid, tcfg.n_out
    if quantized:
        state = {"v": rng.integers(-300, 900, size=(B, H)),
                 "z": rng.integers(0, 2, size=(B, H)),
                 "y": rng.integers(-500, 500, size=(B, O)),
                 "acc_y": rng.integers(-4000, 4000, size=(B, O)),
                 "n_spk": rng.integers(0, 50, size=(B, 1))}
    else:
        state = {"v": rng.normal(size=(B, H)), "z": rng.integers(0, 2, size=(B, H)),
                 "y": rng.normal(size=(B, O)), "acc_y": rng.normal(size=(B, O)),
                 "n_spk": rng.integers(0, 50, size=(B, 1))}
    state = {k: v.astype(np.float32) for k, v in state.items()}

    jout = JaxBackend(jcfg, "kernel", vmem_budget=RAGGED_VMEM).step_sessions(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(raster),
        jnp.asarray(live), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in state.items()})
    tout = ExecutionBackend(tcfg, device="cpu").step_sessions(
        params_from_jax(w, device="cpu"), torch.from_numpy(raster),
        torch.from_numpy(live), torch.from_numpy(valid),
        {k: torch.from_numpy(v) for k, v in state.items()})
    for k in ("v", "z", "y", "acc_y", "n_spk"):
        _check(jout[k], tout[k], quantized)
    # the dead row's carries are untouched exactly
    for k in ("v", "z", "y"):
        np.testing.assert_array_equal(tout[k][3].numpy(), state[k][3])


def test_session_tile_equals_infer_from_zero_state():
    """With zero carries and every tick live, the session kernel's plain
    version reduces to the inference kernel's, bitwise."""
    _, tcfg, w, raster, valid, _ = _tile(4, 16, 5, True)
    be = ExecutionBackend(tcfg, device="cpu")
    p = params_from_jax(w, device="cpu")
    inf = be.inference(p, torch.from_numpy(raster), torch.from_numpy(valid))
    ses = be.step_sessions(p, torch.from_numpy(raster), torch.ones(16, 5),
                           torch.from_numpy(valid), be.init_session_state(5))
    assert torch.equal(inf["acc_y"], ses["acc_y"])


def test_ops_dispatch_by_device_and_count_only_kernel_launches():
    _, tcfg, w, raster, valid, _ = _tile(5, 8, 2, True)
    be = ExecutionBackend(tcfg, device="cpu")
    ops.reset_launch_counts()
    be.inference(params_from_jax(w, device="cpu"), raster, valid)
    be.step_sessions(params_from_jax(w, device="cpu"), raster, valid, valid,
                     be.init_session_state(2))
    assert set(ops.launches) == set(ops.KERNELS)
    assert all(n == 0 for n in ops.launches.values())
    with pytest.raises(ValueError):
        ops.rsnn_infer(torch.zeros(2, 1, 3, device="meta"), None, None, None,
                       None, alpha=0.5, kappa=0.5)


def test_kernel_wrapper_rejects_cpu_tensors():
    """A kernel wrapper takes CUDA tensors only — it never runs the plain
    version for a tensor it was handed."""
    x = torch.zeros(4, 2, 12)
    with pytest.raises(ValueError, match="expected a tensor on"):
        rsnn_step.rsnn_infer_cuda(
            x, torch.zeros(4, 2), torch.zeros(12, 38), torch.zeros(38, 38),
            torch.zeros(38, 3), alpha=0.5, kappa=0.5)


ADMISSION = {(12, 38, 3): 2048, (40, 100, 2): 1024, (256, 256, 16): 512}


@pytest.mark.parametrize("T", [1, 128, 512, 4096])
@pytest.mark.parametrize("dims", [(12, 38, 3), (40, 100, 2), (256, 256, 16)])
def test_tile_sizing_fits_the_block(dims, T):
    """``rsnn_forward``'s plan at every batch: a loop warp a row and the
    helper warps within the serving launch bound, one row a block while
    the SMs hold every row that way, else every row held at once unless a
    block's threads or shared memory cap the rows, the layout within a
    block's shared memory, and every placement taken where it fits: the
    weights, the longest readout chunk, then the rows' raster and input
    currents."""
    n, h, o = dims
    J, E = -(-h // 32), rsnn_step.weight_elems(n, h, o)
    smem = rsnn_step.SMEM_PER_BLOCK
    cap = min(rsnn_step.SERVE_MAX_ROWS,
              rsnn_step.serve_threads(n, h) // 32 - rsnn_step.FORWARD_HELPER_WARPS)
    for B in (1, 7, 70, 1056, 1057, 2048, 5000, ADMISSION[dims]):
        plan = rsnn_step.forward_plan(T, B, n, h, o)
        R = plan.rows
        assert 1 <= R <= cap
        assert plan.threads == 32 * (R + rsnn_step.FORWARD_HELPER_WARPS)
        assert plan.threads <= rsnn_step.serve_threads(n, h)
        held = rsnn_step.H100_SMS * rsnn_step.THREADS_PER_SM // 256   # one-row blocks
        assert (R == 1) == (B <= held) or R == cap or 4 * (R + 1) * (T * J + o) > smem
        if R < cap and 4 * (R + 1) * (T * J + o) <= smem:
            assert rsnn_step.cdiv(B, R) <= held
        assert 1 <= plan.Tl <= T and (plan.Tl == T or not plan.rows_smem)
        words = (plan.weights_smem * E
                 + R * (T * J + plan.Tl * o + plan.rows_smem * T * (n + h)))
        assert plan.smem_bytes == 4 * words <= smem
        if not plan.weights_smem:
            assert 4 * (R * (T * J + o) + E) > smem
        if plan.Tl < T:
            assert plan.smem_bytes + 4 * R * o > smem
        if plan.Tl == T and not plan.rows_smem:
            assert plan.smem_bytes + R * rsnn_step.forward_row_bytes(T, n, h) > smem
    assert rsnn_step.forward_row_bytes(T, n, h) == 4 * T * (n + h)
    # the main path's END_B tile: one row a block, the Braille row on chip
    one = rsnn_step.forward_plan(T, 70, n, h, o)
    assert one.rows == 1 and one.weights_smem == (dims != (256, 256, 16))
    if dims == (12, 38, 3):
        assert one.rows_smem == (T <= 512)


SERVE_DIMS = [(12, 38, 3), (40, 100, 2), (256, 256, 16)]


@pytest.mark.parametrize("T", [1, 7, 256, 4096])
@pytest.mark.parametrize("dims", SERVE_DIMS)
def test_serve_plan_fits_a_block_in_one_wave(dims, T):
    """The serving kernels' plan: a warp a row and a thread per (row,
    output) within the block, the chunk's layout within its shared memory,
    and every admitted row in one wave of blocks."""
    n, h, o = dims
    adm = rsnn_step.max_batch_for_dims(n, h, o)
    for B in (1, 7, 512, adm):
        plan = rsnn_step.serve_plan(T, B, n, h, o)
        assert plan.threads % 32 == 0 and plan.threads <= rsnn_step.THREADS_PER_BLOCK
        assert 1 <= plan.rows and plan.rows * 32 <= plan.threads
        assert plan.rows * o <= plan.threads
        assert 1 <= plan.Tc <= T
        words = (plan.weights_smem * rsnn_step.weight_elems(n, h, o)
                 + plan.rows * plan.Tc * (max(n, o) + h + -(-h // 32) + 2))
        assert plan.smem_bytes == 4 * words <= rsnn_step.SMEM_PER_BLOCK
        assert rsnn_step.cdiv(B, plan.rows) <= rsnn_step.H100_SMS
    # at the admission, the Braille and cue weights stage in shared memory;
    # 256/256/16's cannot
    assert rsnn_step.serve_plan(T, adm, n, h, o).weights_smem == (dims != (256, 256, 16))


def test_serve_plan_chunks_long_tiles():
    """A B=512 Braille tile at T=256 runs in one chunk; the 2,048-row
    admission tile and the longest tick count run in several."""
    assert rsnn_step.serve_plan(256, 512, 12, 38, 3).Tc == 256
    assert rsnn_step.serve_plan(256, 2048, 12, 38, 3).Tc < 256
    for dims in SERVE_DIMS:
        assert rsnn_step.serve_plan(4096, 1, *dims).Tc < 4096


def test_backend_tile_rows_report_the_serve_plan():
    for n, h, o in SERVE_DIMS:
        be = ExecutionBackend(Presets.braille(num_ticks=8, n_in=n, n_hid=h, n_out=o),
                              device="cpu")
        adm = rsnn_step.max_batch_for_dims(n, h, o)
        for op in ("inference", "step_sessions"):
            assert be.tile_rows(op) == rsnn_step.serve_plan(1, adm, n, h, o).rows
            for B in (1, 70, 512, adm):
                assert be.tile_rows(op, T=256, B=B) == rsnn_step.serve_plan(
                    256, B, n, h, o).rows
    with pytest.raises(ValueError, match="unknown op"):
        be.tile_rows("serve")


def test_serve_event_flops_count_events_and_the_leaks():
    """A hand-built raster whose spikes are known: w_in drives neuron k
    over threshold at every input event on input k, nothing else does
    (no recurrence, no memory), so the spikes are the input events."""
    from repro_torch.kernels import traffic

    T, B, n, h, o = 4, 2, 2, 2, 3
    raster = torch.zeros(T, B, n)
    raster[0, 0, 0] = raster[0, 0, 1] = raster[2, 1, 1] = raster[3, 1, 0] = 1.0
    fwd = rsnn_step.rsnn_forward_plain(raster, 2 * torch.eye(n), torch.zeros(h, h),
                                       torch.ones(h, o), alpha=0.0, kappa=0.5)
    z = fwd["z"]
    assert torch.equal(z, raster)                # 4 spikes; 3 before the last tick
    events, spikes, fed_back = (int(raster.count_nonzero()), int(z.count_nonzero()),
                                int(z[:-1].count_nonzero()))
    assert (events, spikes, fed_back) == (4, 4, 3)
    want = 2 * h * (4 + 3) + 2 * o * 4 + T * B * (2 * h + 4 * o)
    assert traffic.serve_event_flops(T, B, n, h, o, events, spikes, fed_back) == want


def test_forward_event_flops_count_events_leaks_and_filters():
    """The hand-built raster of the serving count's test: its spikes are
    its input events.  The forward adds, every row and tick, the membrane
    leak and the pbar, zbar filters (H each), the xbar filter (N) and the
    readout leak (O), a multiply and an add each."""
    from repro_torch.kernels import traffic

    T, B, n, h, o = 4, 2, 2, 2, 3
    raster = torch.zeros(T, B, n)
    raster[0, 0, 0] = raster[0, 0, 1] = raster[2, 1, 1] = raster[3, 1, 0] = 1.0
    z = rsnn_step.rsnn_forward_plain(raster, 2 * torch.eye(n), torch.zeros(h, h),
                                     torch.ones(h, o), alpha=0.0, kappa=0.5)["z"]
    assert torch.equal(z, raster)
    events, spikes, fed_back = (int(raster.count_nonzero()), int(z.count_nonzero()),
                                int(z[:-1].count_nonzero()))
    assert (events, spikes, fed_back) == (4, 4, 3)
    want = 2 * h * (4 + 3) + 2 * o * 4 + T * B * (2 * h + 2 * h + 2 * h + 2 * n + 2 * o)
    assert traffic.forward_event_flops(T, B, n, h, o, events, spikes, fed_back) == want


def test_tick_transition_matches_jax():
    from repro.core.quant import QuantizedMode as JQ
    from repro.kernels.rsnn_step import tick_transition as jtick
    from repro_torch.core.quant import QuantizedMode
    from repro_torch.kernels.rsnn_step import tick_transition

    rng = np.random.default_rng(9)
    q = QuantizedMode()
    B, N, H, O = 4, 12, 38, 3
    x = (rng.random((B, N)) < 0.4).astype(np.float32)
    v = rng.integers(-2048, 2047, size=(B, H)).astype(np.float32)
    z = rng.integers(0, 2, size=(B, H)).astype(np.float32)
    y = rng.integers(-2048, 2047, size=(B, O)).astype(np.float32)
    ws = [(rng.integers(-128, 128, size=s) * 63).astype(np.float32)
          for s in ((N, H), (H, H), (H, O))]
    kw = dict(alpha=q.alpha, kappa=q.kappa, v_th=1008.0, reset_sub=False)
    jo = jtick(*(jnp.asarray(a) for a in (x, v, z, y, *ws)), quant=JQ(),
               boxcar_width=0.5, **kw)
    to = tick_transition(*(torch.from_numpy(a) for a in (x, v, z, y, *ws)),
                         quant=q, boxcar_width=0.5, **kw)
    assert len(to) == len(jo) == 4      # (v, z, y, boxcar h)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_port_never_imports_jax_or_repro():
    root = pathlib.Path(__file__).resolve().parents[1]
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b)", re.M)
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(p) for p in files if bad.search(p.read_text())]
    assert offenders == []


def test_backend_without_cuda_raises_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Presets.braille(num_ticks=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExecutionBackend(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExecutionBackend(cfg, device="cuda")
    assert ExecutionBackend(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["rsnn_forward", "rsnn_train", "eprop_update"])
def test_training_wrappers_reject_cpu_tensors(name):
    from repro_torch.kernels import eprop_update

    T, B, N, H, O = 4, 2, 12, 38, 3
    z = torch.zeros
    calls = {
        "rsnn_forward": lambda: rsnn_step.rsnn_forward_cuda(
            z(T, B, N), z(N, H), z(H, H), z(H, O), alpha=0.5, kappa=0.5),
        "rsnn_train": lambda: eprop_update.rsnn_train_cuda(
            z(T, B, N), z(B, O), z(T, B), z(N, H), z(H, H), z(H, O), z(H, O),
            alpha=0.5, kappa=0.5),
        "eprop_update": lambda: eprop_update.eprop_update_cuda(
            z(T, B, H), z(T, B, N), z(T, B, H), z(T, B, H), z(T, B, O), z(H, O),
            kappa=0.5),
    }
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="expected a tensor on"):
        calls[name]()
    assert ops.launches[name] == 0


@pytest.mark.parametrize("dims", [(12, 38, 3), (40, 100, 2), (256, 256, 16)])
def test_trace_tile_sizing_fits_the_block(dims):
    """The serving admission is the rows the serving kernels run at once
    (a warp a row, the SMs' neuron slots), unchanged from the tile loop's
    sizing; a forward whose spike masks alone exceed a block raises; the
    trace ops report ``forward_plan``'s rows a block (one at the END_B
    tile, two at 2,048 rows)."""
    n, h, o = dims
    J = -(-h // 32)
    assert rsnn_step.max_batch_for_dims(n, h, o) == ADMISSION[dims]
    assert rsnn_step.serve_rows_per_sm(h) * 32 * J <= rsnn_step.THREADS_PER_BLOCK
    t_max = (rsnn_step.SMEM_PER_BLOCK - 4 * o) // (4 * J)
    assert rsnn_step.forward_plan(t_max, 1, n, h, o).smem_bytes <= rsnn_step.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="spike masks exceed"):
        rsnn_step.forward_plan(t_max + 1, 1, n, h, o)
    be = ExecutionBackend(Presets.braille(num_ticks=8, n_in=n, n_hid=h, n_out=o),
                          device="cpu")
    for op in ("forward_traces", "dynamics"):
        assert be.tile_rows(op) == rsnn_step.forward_plan(1, ADMISSION[dims], n, h, o).rows
        for T, B in ((128, 1), (128, 70), (128, 2048), (4096, 2048)):
            assert be.tile_rows(op, T=T, B=B) == rsnn_step.forward_plan(T, B, n, h, o).rows
        assert be.tile_rows(op, T=128, B=70) == 1
    assert be.tile_rows("forward_traces", T=128, B=2048) == 2
    assert be.tile_rows("train", T=128) == 1        # one row a block
    with pytest.raises(ValueError, match="T <= 4096"):
        be.tile_rows("train")


@pytest.mark.parametrize("dims,T,on_chip", [
    ((12, 38, 3), 128, True),          # Braille at the dataset's T: 66 KB a row
    ((12, 38, 3), 256, True),
    ((12, 38, 3), 512, False),         # long T: the device scratch
    ((40, 100, 2), 100, True),
    ((40, 100, 2), 150, False),
    ((256, 256, 16), 128, False),      # the chip maximum: 532 KB a row
    ((256, 256, 16), 4096, False),     # the 12-bit tick counter's longest
])
def test_train_plan_places_the_trace_set(dims, T, on_chip):
    """rsnn_train keeps a row's trace set in shared memory, beside the
    weights, where both fit, and in a device scratch otherwise; the valid
    and spike masks always stay on chip, and a block never asks for more
    than the card's 227 KB."""
    n, h, o = dims
    plan = rsnn_step.train_plan(T, n, h, o)
    assert plan.traces_smem == on_chip
    assert plan.weights_smem == (dims != (256, 256, 16))
    assert plan.smem_bytes <= rsnn_step.SMEM_PER_BLOCK
    words = (4 * -(-T // plan.ticks) + T * (1 + -(-h // 32))
             + plan.weights_smem * rsnn_step.weight_elems(n, h, o)
             + plan.traces_smem * T * (3 * h + n + o))
    assert plan.smem_bytes == 4 * words
    assert rsnn_step.train_trace_bytes(T, n, h, o) == 4 * T * (3 * h + n + o)
    assert plan.threads >= 64 and plan.threads % 32 == 0   # a loop warp + the rest


# The shared-memory layout of csrc/rsnn_train.cuh:rsnn_train_smem_floats,
# in 4-byte words: two mbarriers a tick block, the valid and spike masks,
# the weights when staged, the trace set when on chip.
def _train_smem_words(T, n, h, o, ticks, weights_smem, traces_smem):
    w = n * h + h * h + h * o if weights_smem else 0
    tr = T * (3 * h + n + o) if traces_smem else 0
    return 4 * -(-T // ticks) + T * (1 + -(-h // 32)) + w + tr


@pytest.mark.parametrize("dims", [(12, 38, 3), (40, 100, 2), (256, 256, 16), (7, 9, 1)])
@pytest.mark.parametrize("T", [1, 31, 128, 256, 424, 425, 512])
@pytest.mark.parametrize("B", [1, 2, 16, 17, 70, 512])
def test_train_plan_clusters_small_batches(dims, T, B):
    """``train_plan`` at (T, B): the blocks fit shared memory on either
    route; a row spans a cluster of 1, 2, 4 or 8 blocks, more than one only
    with the trace set on chip, the widest whose ``B`` rows still fit the
    card's SMs twice over (eight at END_S's one row, one at the END_B
    tile); the bytes are the layout the kernel checks; the plan is a
    function of (T, N, H, O, B) alone, and B moves nothing but the
    cluster."""
    n, h, o = dims
    plan = rsnn_step.train_plan(T, n, h, o, B)
    assert plan.smem_bytes <= rsnn_step.SMEM_PER_BLOCK
    assert plan.smem_bytes == 4 * _train_smem_words(T, n, h, o, plan.ticks,
                                                    plan.weights_smem, plan.traces_smem)
    assert plan.threads == rsnn_step.TRAIN_THREADS and plan.ticks >= 1
    assert plan.cluster in (1, 2, 4, 8)
    if not plan.traces_smem:
        assert plan.cluster == 1
    else:
        assert plan.cluster == 1 or B * plan.cluster <= rsnn_step.H100_SMS
        assert plan.cluster == 8 or B * 2 * plan.cluster > rsnn_step.H100_SMS
    if B == 1 and plan.traces_smem:
        assert plan.cluster == 8
    if B == 70:
        assert plan.cluster == 1
    assert rsnn_step.train_plan(T, n, h, o, B) == plan
    assert dataclasses.replace(rsnn_step.train_plan(T, n, h, o, 1), cluster=plan.cluster) \
        == plan


def test_train_plan_keeps_braille_on_chip_to_t424():
    """The mbarriers leave Braille's trace set in shared memory up to
    T=424, as before them (88 bytes to spare), and on the device scratch
    from T=425."""
    assert rsnn_step.train_plan(424, 12, 38, 3).traces_smem
    assert rsnn_step.SMEM_PER_BLOCK - rsnn_step.train_plan(424, 12, 38, 3).smem_bytes == 88
    assert not rsnn_step.train_plan(425, 12, 38, 3).traces_smem
    assert rsnn_step.train_barrier_bytes(424, rsnn_step.TRAIN_TICKS) == 16 * 27


def test_train_event_flops_count_events_and_the_dense_reverse():
    """``rsnn_train``'s count is its forward's (the event sums, the leaks
    and the three filters every row and tick) plus the dense reverse."""
    from repro_torch.kernels import traffic

    T, B, n, h, o = 128, 70, 12, 38, 3
    rev = 2 * T * B * (rsnn_step.weight_elems(n, h, o) + h * o)
    fwd = T * B * 2 * (3 * h + n + o)
    assert traffic.train_event_flops(T, B, n, h, o, 0, 0, 0) == rev + fwd
    assert traffic.train_event_flops(T, B, n, h, o, 10, 7, 5) == (
        rev + fwd + 2 * h * 15 + 2 * o * 7)
    for ev in ((0, 0, 0), (10, 7, 5)):
        assert traffic.train_event_flops(T, B, n, h, o, *ev) == (
            traffic.forward_event_flops(T, B, n, h, o, *ev) + rev)


def test_train_plan_rejects_masks_past_a_block():
    with pytest.raises(ValueError, match="shared memory"):
        rsnn_step.train_plan(8192, 256, 256, 16)


def test_training_traffic_formulas_match_jax():
    from repro.kernels import traffic as jt
    from repro_torch.kernels import traffic

    for shape in [(128, 70, 12, 38, 3), (256, 8, 256, 256, 16)]:
        assert traffic.forward_traces_bytes(*shape) == jt.forward_traces_bytes(*shape)
        assert traffic.eprop_update_bytes(*shape) == jt.eprop_update_bytes(*shape)
        T, B, n, h, o = shape
        # the card reads the raster and valid once (no phase-2 re-visit) and
        # pads no rows
        want = 4 * (T * B * n + T * B + B * o + rsnn_step.weight_elems(n, h, o) + h * o
                    + rsnn_step.weight_elems(n, h, o) + B * o + B)
        assert traffic.train_fused_tiled_bytes(*shape) == want
