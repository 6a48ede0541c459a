"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``bayhunter_tpu_torch/csrc`` with
nvcc (one process per source, started together): K1 model operands, K2
warm root walker (Rayleigh and Love), K3 RF response (uniform Q, P and
SV), K3r RF response (per-layer Q, P and SV), K4/K5 Rayleigh and Love
secular values, K6 RF operands.  Checks each against its plain PyTorch
twin on the card at the main paths' shapes (10,240 chains, 21 layer
slots; K1 with one and with two RF targets, also on 2,048 chains; K4/K5
on the first 64-candidate counting block of 21 periods of 10,240 grown
models, and on one cold-init chunk of 2,048 initial single-layer models
as ``init_states_host`` draws them at the cold search's three grids,
sign 0, counting block and refinement; K6 for P and SV on 10,240 models
and on that chunk; K3 at the warm 99 and the cold 257 frequencies; K3r
at 99 frequencies on path A's models and Q), timing both with CUDA
events (K1, K6, and K4/K5 on the cold chunk: the kernel's device time
by torch.profiler, after the main paths, and the wrapper's back-to-back
calls by CUDA events beside it; K4/K5 at 10,240 chains by both) beside
the kernel's bound (the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s, the H100's float32 peak, counted from this
run's inputs), and prints K1's, K2's, K3's, K4/K5's and K6's launch
geometry (K4/K5 with the occupancy calculator's resident warps per SM)
and K2's and K3's executed-per-useful lane work.  Runs the ragged
shapes of ``tests/test_torch_cuda.py`` (C = 1, 37, 10,237 chains; K2 at
R = 1, 21, 60 periods, K3/K3r at F = 1, 99, 257 lanes; K4/K5 on C = 1,
7, 2,051 chains of 2, 21, 64 slots) bit for bit against the twins.
Checks the tutorial
truth model against the committed golden data
(``tests/fixtures/st3_*.dat``): the cold Rayleigh and Love solves (K4,
K5), the cold P and S receiver functions (K6, K3 at 257 frequencies),
the warm walker for both wave types (K2), the warm P and S receiver
functions (K3), and ``rf.synrf`` with uniform Q given as arrays (K6,
K3r) for both waves.

Then it drives four paths through the port's entry points, each with
every launch count set to 0 just before it and read just after:

  * ``tutorial`` — ``bench.py``'s tutorial joint inversion (Rayleigh
    phase + P-RF): cold init of 10,240 chains (K4, K6, K3), early
    cycles up to the early cutoff, timed late cycles (K1, K2, K3);
  * ``tutorial_rl_prf`` — the same with Love phase as a third target:
    cold init (K4, K5, K6, K3), early cycles, timed late cycles (K1,
    K2 for both wave types, K3);
  * path A, ``synrf_batch`` — the public batched RF forward of 10,240
    grown models under a seeded per-layer Q model, P and SV (K6, K3r);
  * ``tutorial_prf_srf`` — Rayleigh phase + P-RF + S-RF: cold init (K4,
    K6 and K3 for both waves), early cycles, timed late cycles (K1 with
    two RF operand sets, K2, K3 twice per model step).

Last it profiles the late steps of ``tutorial``: host-clock time per
move, and under ``torch.profiler`` the device's busy and idle share and
each kernel's device time, and each configuration's cold init: its wall
time, and under the profiler the device time of K3, K4, K5 and K6 and
the device's busy time.  It prints one line per
phase (the host CPU among them, since the host-side work sets the
rate), the card's name and power limit, the kernels' JSON line, and
last
``{"ok": true, "device": ...}``.

Any mismatch or exception ends the run with a non-zero exit; without a
CUDA device it exits non-zero before doing anything.
"""

import json
import os
import platform
import subprocess
import sys
import time

import numpy as np

C_MAIN = 10240
NL = 21
ITERS = 2000          # bench.py's iter_burnin = iter_main
LATE_CYCLES = 64      # timed late cycles of each main path
PATH_A_CALLS = 5      # synrf_batch calls of path A per wave type
KERNEL_REPS = 20
STEP_REPS = 20        # host-clock steps per move in the profile phase
PROFILE_CYCLES = 4    # late cycles under torch.profiler
COLD_CHUNK = 2048      # chains per cold-init chunk (evaluator.COLD_CHUNK)
# device kernel names, as the profiler lists them
KERNEL_NAMES = {'K1': '::prep_kernel(', 'K2': 'walk_kernel',
                'K3': 'resp_kernel', 'K4': 'secular_kernel<2>',
                'K5': 'secular_kernel<1>', 'K6': 'rf_prep_kernel'}
WARM_KERNELS = ('K1', 'K2', 'K3')     # the kernels of a late step
# kernel entries whose ptxas lines tools/kernel_variants.py reports
PTXAS_KERNELS = ('prep_kernel', 'walk_kernel', 'resp_kernel',
                 'secular_kernel')

# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
# Float32 operations per unit of work, counted by hand from csrc/ (an
# add, multiply, divide, compare-select, square root or other
# transcendental is one operation each).
OPS = dict(
    dunkin_layer=200,     # secular.cuh dltar4_layer
    dunkin_fixed=45,      # wavenumber, halfspace start, water clause
    haskell_layer=30,     # secular.cuh dltar1_layer
    haskell_fixed=12,     # wavenumber, halfspace start
    walk_eval=12,         # walker bookkeeping around one evaluation
    resp_layer=450,       # resp.cu: two phase terms, the 2x2 algebra
    resp_fixed=500,       # resp.cu: Q factors, surface layer, closure
    resp_q_phase=18,      # resp.cu phase_q over phase: the complex
    #                       velocity (6), its square (6), its inverse (6)
    resp_q_slot=3,        # resp.cu: the Q-contrast test of one slot
    rf_interface=420,     # cplx.cuh interface_coeffs + skip-depth test
    rf_flatten_slot=15,   # prep.cu flatten: two logs, a quotient
    rf_t0_slot=10,        # prep.cu rf_rows: t0 term of one slot
    rf_fixed=150,         # displacement and free-surface matrices
    model_slot=35,        # voronoi, validity and SWD rows of one slot
    model_fixed=150,      # gtsolh's five Newton steps
)


def log(msg):
    print(msg, flush=True)


def host_cpu():
    """The host CPU's model name and the logical CPUs this process may
    use."""
    name = platform.processor() or 'unknown'
    if os.path.exists('/proc/cpuinfo'):
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('model name'):
                    name = line.split(':', 1)[1].strip()
                    break
    return '%s, %d logical CPUs' % (name, len(os.sched_getaffinity(0)))


def timed(fn, reps):
    """ms per call of ``fn`` with CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(fn, reps, name):
    """Median device time (ms) of the kernel named ``name`` (a substring
    of the profiler's kernel name) over ``reps`` calls of ``fn`` under
    torch.profiler, after one warm-up: the kernel alone, without the
    wrapper's host time that CUDA events around back-to-back calls
    hold."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the profiler may drop a launch's record, or now and then all of a
    # session's (PERF.md), never add one: a session that recorded none
    # is run again, at most three in all
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if us:
            break
        log('the profiler recorded no launch of %s in %d calls; '
            'profiling again' % (name, reps))
    if not 0 < len(us) <= reps:
        raise AssertionError('the profiler saw %d launches of %s in %d '
                             'calls' % (len(us), name, reps))
    return 1e-3 * float(np.median(us))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def entry(counter, name, source, replaces, err, ms, plain_ms, moved, ops,
          wrapper_ms=None):
    """One kernel's record of the JSON line: ``moved`` bytes (each input
    read once, each output written once) and ``ops`` float32 operations
    that this run's inputs need give the bound; ``counter`` names its
    launch count in :func:`launch_counts`.  ``ms`` is the kernel's time
    by CUDA events over back-to-back wrapper calls; for K1, K6 and K4/K5
    on the cold chunk, whose wrappers take about as long on the host as
    the kernel on the card, it is None until :func:`profile_kernels`
    fills in the profiler's device time, and the event time is
    ``wrapper_ms``."""
    t_bytes = 1e3 * moved / PEAK_BYTES
    t_ops = 1e3 * ops / PEAK_FLOPS
    rec = dict(counter=counter, name=name, route='cuda',
               source='bayhunter_tpu_torch/csrc/' + source,
               replaces='bayhunter_tpu/ops/' + replaces,
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by='bytes' if t_bytes >= t_ops else 'operations',
               library_ms=None)
    if wrapper_ms is None:
        rec['bound_share'] = rec['bound_ms'] / ms
    else:
        rec['wrapper_ms'] = wrapper_ms
    return rec


def profile_kernels(torch, dev, kernels):
    """The profiler's device time of the records that wait for it (K1,
    K6, K4/K5 on the cold chunk) and of K4/K5 at 10,240 chains
    (``device_ms``, beside their event time), on inputs made anew, and a
    log of K4/K5 on the cold chunk's other two grids.  Runs after the
    main paths: a torch.profiler session leaves the host's later kernel
    launches slower, which would lower the rates measured after it."""
    calls = profiled_calls(torch, *phase_inputs(torch, dev))
    for k in kernels:
        if k['ms'] is None:
            k['ms'] = profiled(calls[k['counter']], KERNEL_REPS,
                               KERNEL_NAMES[k['counter'][:2]])
            k['bound_share'] = k['bound_ms'] / k['ms']
        elif k['counter'] in ('K4', 'K5'):
            k['device_ms'] = profiled(calls[k['counter']], KERNEL_REPS,
                                      KERNEL_NAMES[k['counter']])
    log('K4/K5 on the cold chunk\'s sign-0 and refine grids, device ms '
        '(profiler): ' + json.dumps({
            key: profiled(call, KERNEL_REPS, KERNEL_NAMES[key[:2]])
            for key, call in calls.items()
            if key[2:].startswith('_cold_')}))


def grown_models(C, nl, seed=3):
    """Seeded 5-8 layer models around the tutorial truth (the
    distribution of tests/test_dim_reject_pin.py _grown_states)."""
    rs = np.random.RandomState(seed)
    VS = np.zeros((C, nl), np.float32)
    Z = np.zeros((C, nl), np.float32)
    N = np.zeros(C, np.int32)
    for i in range(C):
        nex = rs.randint(1, 5)
        n = 4 + nex
        znuc = np.sort(np.concatenate([
            np.array([2.5, 15., 32., 48.]) + rs.uniform(-1.5, 1.5, 4),
            rs.uniform(1., 58., nex)]))
        vsn = np.interp(znuc, [0, 5, 5.01, 28, 28.01, 36, 36.01, 60],
                        [2.7, 2.7, 3.6, 3.6, 3.8, 3.8, 4.4, 4.4])
        vsn = vsn + rs.normal(0, 0.05, n)
        VS[i, :n] = np.sort(vsn)
        Z[i, :n] = znuc
        VS[i, n:] = VS[i, n - 1]
        Z[i, n:] = 120.0
        N[i] = n
    return VS, Z, N


def secular_ops(top, evaluations, iwave):
    """Operations of the secular function: ``evaluations`` per chain (a
    number, or (C, R) per lane), each running the chain's layers
    top..0."""
    layer, fixed = ((OPS['haskell_layer'], OPS['haskell_fixed'])
                    if iwave == 1 else
                    (OPS['dunkin_layer'], OPS['dunkin_fixed']))
    per_eval = fixed + (top.double()[:, None] + 1.0) * layer
    return float((evaluations * per_eval).sum())


def warm_starts(torch, layers, periods, iwave):
    """K2's inputs of the kernel phase, (c_prev, slopes) each (C, R):
    the cold roots and bracket slopes of the (C, NL) ``layers`` (K4 or
    K5, 2,048 chains at a time), the roots moved off the DDC grid by a
    seeded offset."""
    from bayhunter_tpu_torch.ops import swd

    roots, slopes = [], []
    for i in range(0, layers[0].shape[0], 2048):
        _, _, r_, s_ = swd.surfdisp_roots_cold(
            *(x[i:i + 2048] for x in layers), periods, iwave)
        roots.append(r_)
        slopes.append(s_)
    roots, slopes = torch.cat(roots), torch.cat(slopes)
    gen = torch.Generator(device=roots.device)
    gen.manual_seed(11)
    return roots + 0.0013 + 0.04 * (torch.rand(
        roots.shape, generator=gen, device=roots.device) - 0.5), slopes


def check_walker(torch, counter, name, iwave, wargs, slopes):
    """K2 for one wave type against its twin, for each move class:
    (record, max error).  The bound counts the secular evaluations each
    lane makes (the twin counts them)."""
    from bayhunter_tpu_torch.ops import lanes, swd, walk

    props, omegas, c_prev, cm, bx, top = wargs
    R = omegas.shape[0]
    top_np = np.minimum(top.cpu().numpy().astype(np.int64), NL - 2)
    lane_map = walk.lane_map(walk.geometry(C_MAIN, R, NL, iwave), C_MAIN, R,
                             top_np)
    err = ms = plain_ms = moved = ops = 0.0
    for move, st in (('vs', swd.WARM_VS), ('z', swd.WARM_Z),
                     ('dim', swd.WARM_DIM)):
        sl = slopes if st['cached_slope'] else None
        kw = dict(ring_k=st['ring'], trips=swd.WARM_CAP,
                  nbisect=st['nbisect'], newton_iters=st['newton_iters'],
                  newton_maxshift=swd.NEWTON_MAXSHIFT, slope_prev=sl,
                  iwave=iwave)
        kc, kf, ks = walk.warm_roots_walk(*wargs, **kw)
        pc, pf, ps = walk.warm_roots_walk_plain(*wargs, **kw)
        evals = walk.warm_roots_walk_plain.evaluations
        torch.cuda.synchronize()
        flips = float((kf != pf).float().mean())
        both = kf & pf
        d = (kc - pc).abs()[both]
        p90 = float(torch.quantile(d.float(), 0.9)) if d.numel() else 0.0
        dmax = float(d.max()) if d.numel() else 0.0
        bitwise = bool(torch.equal(kc, pc) and torch.equal(kf, pf)
                       and torch.equal(ks, ps))
        err = max(err, dmax)
        ev = evals.cpu().numpy()
        done, use = walk.lane_work(C_MAIN, R, NL, iwave, top_np, ev)
        walks, evs = lanes.executed_work(lane_map, ev, np.ones(C_MAIN * R))
        log('%s (%s moves): found %.4f, found flags differ on %.2e of '
            'lanes (limit 1e-4), root p90 %.3g (limit 2e-5), max %.3g '
            '(limit 5e-4), bitwise %s, %.2f evaluations per lane, executed '
            '/ useful layer-evaluations %.4f (%.4f with one layer per '
            'evaluation: the walk lengths alone)'
            % (name, move, float(kf.float().mean()), flips, p90, dmax,
               bitwise, float(evals.double().mean()), done / use,
               walks / evs))
        if not (flips <= 1e-4 and p90 < 2e-5 and dmax < 5e-4 and bitwise):
            raise AssertionError('%s differs from its twin' % name)
        ms += timed(lambda: walk.warm_roots_walk(*wargs, **kw), KERNEL_REPS)
        plain_ms += timed(lambda: walk.warm_roots_walk_plain(*wargs, **kw),
                          2)
        moved += nbytes(props, omegas, c_prev, cm, bx, top, sl, kc, kf, ks)
        ops += secular_ops(top.clamp(max=NL - 2), evals.double(), iwave)
        ops += OPS['walk_eval'] * float(evals.double().sum())
    log('%s: geometry %s' % (name, walk.geometry(C_MAIN, R, NL, iwave)))
    return entry(counter, name, 'walk.cu', 'pallas_walk.py:71', err, ms / 3,
                 plain_ms / 3, moved / 3, ops / 3)


def q_model(N, nl, seed=5):
    """Path A's seeded attenuation model of the :func:`grown_models` with
    nucleus counts ``N``, (C, nl) float32: Qs per model layer in 50-600
    increasing with depth, the halfspace's Q in the padded slots (as
    its velocities), Qp = 2.25 Qs."""
    rs = np.random.RandomState(seed)
    qs = np.zeros((len(N), nl), np.float32)
    for i, n in enumerate(N):
        qs[i, :n] = np.sort(rs.uniform(50.0, 600.0, n))
        qs[i, n:] = qs[i, n - 1]
    return np.float32(2.25) * qs, qs


def grown_layers(torch, dev):
    """(C, NL) layer arrays h, vp, vs, rho of :func:`grown_models` and
    their (C, NL) Qp, Qs of :func:`q_model`: path A's inputs."""
    from bayhunter_tpu_torch.ops import voronoi
    VS, Z, N = grown_models(C_MAIN, NL)
    layers = voronoi.voronoi_to_layers(
        torch.tensor(VS, device=dev), torch.tensor(Z, device=dev),
        torch.tensor(N, device=dev),
        torch.full((C_MAIN,), 1.73, dtype=torch.float32, device=dev))
    qp, qs = (torch.tensor(q, device=dev) for q in q_model(N, NL))
    return layers, qp, qs


def check_bitwise(torch, tag, kernel_out, plain_out):
    """Max |kernel - twin| over matching tensors; fails unless equal."""
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(kernel_out,
                                                         plain_out))
    log('%s: max |kernel - twin| = %.3g (bitwise required)' % (tag, err))
    if not all(bool(torch.isfinite(a).all()) and torch.equal(a, b)
               for a, b in zip(kernel_out, plain_out)):
        raise AssertionError('%s differs from its twin' % tag)
    return err


def phase_inputs(torch, dev):
    """The kernel phase's inputs of K1, K6 and the cold chunk's K4/K5:
    the ``tutorial_prf_srf`` evaluator (priors, RF specs), the (NL, C)
    nuclei of :func:`grown_models` (vpvs 1.73), their (NL, C) layer
    planes, and the (C, NL) layer arrays of :func:`cold_chunk`."""
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.ops import voronoi
    _, ev = bench_config.build_prf_srf(dev, iters=ITERS, nl=NL)
    VS, Z, N = grown_models(C_MAIN, NL)
    nuclei = (torch.tensor(VS.T.copy(), device=dev),
              torch.tensor(Z.T.copy(), device=dev),
              torch.tensor(N, device=dev),
              torch.full((C_MAIN,), 1.73, dtype=torch.float32, device=dev))
    return (ev, nuclei, voronoi.voronoi_to_layers_T(*nuclei),
            cold_chunk(torch, dev))


def secular_grids(torch, layers, omegas):
    """The cold search's three candidate grids on the (C, NL) ``layers``
    at the angular frequencies ``omegas`` (R,), each broadcast as the
    search's drivers pass it to K4/K5 (``swd._find_brackets_b``,
    ``_ksection_refine``): name -> (velocities, frequencies).  ``sign0``:
    cm (C, 1) against (C, R); ``count``: the first counting block, 64
    velocities above cm, (C, 1, 64) against (C, R, 1); ``refine``: 17
    points across the DDC step of each period's Rayleigh bracket, which
    the counting search finds (K4), (C, R, 17) against (C, R, 1)."""
    from bayhunter_tpu_torch.ops import swd
    dev = layers[0].device
    C, R = layers[0].shape[0], omegas.shape[0]
    omega = omegas.expand(C, R)
    cm, betmx = (x[:, None] for x in swd.lower_bound(layers[1], layers[2],
                                                     dim=-1))
    koff = torch.arange(1, swd.KBLOCK + 1, device=dev) * swd.DDC
    lo, _ = swd._find_brackets_b(
        omega, cm, betmx, lambda c, om: swd.secular_at(c, om, *layers, 2),
        swd.KBLOCK, swd.NBLOCKS)
    fracs = (torch.arange(0, swd.KREFINE + 2, device=dev)
             / (swd.KREFINE + 1))
    return {'sign0': (cm, omega),
            'count': (cm[..., None] + koff, omega[..., None]),
            'refine': (lo[..., None] + swd.DDC * fracs, omega[..., None])}


def regime_split(torch, layers, c, omega, iwave):
    """Share of the (warp, applied layer) pairs of a K4 (``iwave`` 2) or
    K5 (1) launch on the grid (c, omega) whose lanes split between the
    propagating and the evanescent branch of the layer's P or S term
    (``secular.cuh`` ``var_quantities``), so that the warp runs both: a
    warp takes 32 consecutive candidates of one chain's R * K."""
    from bayhunter_tpu_torch.ops import swd
    h, vp, vs, _ = layers
    C = h.shape[0]
    shape = torch.broadcast_shapes(c.shape, omega.shape)
    om = torch.clamp(omega, min=1.0e-4).expand(shape).reshape(C, -1)
    wvno = (omega / c).expand(shape).reshape(C, -1)
    E = wvno.shape[1]
    pad = -(-E // 32) * 32 - E
    live = torch.arange(E + pad, device=h.device) < E
    top = swd.layer_top(h)
    water = vs[:, 0] <= 0.0
    split = total = 0
    for l in range(int(top.max()) + 1):
        applied = (top >= l) & ~(water & (l == 0))
        mixed = torch.zeros((C, (E + pad) // 32), dtype=torch.bool,
                            device=h.device)
        speeds = (vp, vs) if iwave == 2 else (torch.where(
            vs > 0.0, vs, torch.ones_like(vs)),)
        for v in speeds:
            prop = torch.nn.functional.pad(wvno < om / v[:, l:l + 1],
                                           (0, pad))
            prop = prop.reshape(C, -1, 32)
            lanes = live.reshape(-1, 32)
            mixed |= (prop & lanes).any(-1) & (~prop & lanes).any(-1)
        split += int((mixed & applied[:, None]).sum())
        total += int(applied.sum()) * mixed.shape[1]
    return split / max(total, 1)


def secular_call(layers, c, omega, iwave):
    """K4 (``iwave`` 2) or K5 (1) on a grid: the wrapper call that the
    records time."""
    from bayhunter_tpu_torch.ops import swd
    return lambda: swd.secular_at(c, omega, *layers, iwave)


def profiled_calls(torch, ev, nuclei, planes, cold):
    """{record counter: the wrapper call its times are taken on} of the
    kernels that the profiler times: K1 with the main path's P-RF target
    and with tutorial_prf_srf's P- and S-RF targets, K6 (P) at 10,240
    chains and on the cold chunk, K4/K5 on the first counting block of
    the 10,240 grown models and on the cold chunk's three grids
    (``K4_cold`` its counting block, ``K4_cold_sign0``,
    ``K4_cold_refine``)."""
    from bayhunter_tpu_torch.ops import prep
    p = ev.specs[1].p_skm
    cplanes = tuple(x.T.contiguous() for x in cold)
    grown = tuple(x.T.contiguous() for x in planes)
    omegas = ev.specs[0].omegas
    calls = {
        'K1': lambda: prep.model_operands(*nuclei, ev.priors,
                                          ev.rf_specs[:1]),
        'K1_2rf': lambda: prep.model_operands(*nuclei, ev.priors,
                                              ev.rf_specs),
        'K6': lambda: prep.rf_operands(*planes, p),
        'K6_cold': lambda: prep.rf_operands(*cplanes, p)}
    for kernel, iwave in (('K4', 2), ('K5', 1)):
        calls[kernel] = secular_call(
            grown, *secular_grids(torch, grown, omegas)['count'], iwave)
        for name, grid in secular_grids(torch, cold, omegas).items():
            key = kernel + '_cold' + ('' if name == 'count' else '_' + name)
            calls[key] = secular_call(cold, *grid, iwave)
    return calls


def check_kernels(torch, dev):
    """Each kernel against its twin on the card at main-path shapes."""
    from bayhunter_tpu_torch.ops import prep, resp, rf, swd

    ev, nuclei, planes, cold = phase_inputs(torch, dev)
    calls = profiled_calls(torch, ev, nuclei, planes, cold)
    out = []

    # K1, with the P-RF spec of the main path and with the P- and S-RF
    # specs of tutorial_prf_srf, at 10,240 chains and at a cold chunk's
    # width; the wrapper's back-to-back calls timed by CUDA events (the
    # kernel by the profiler, last)
    for specs, counter, tag in (
            (ev.rf_specs[:1], 'K1', 'K1 model operands'),
            (ev.rf_specs, 'K1_2rf', 'K1 model operands (P- and S-RF)')):
        args = nuclei + (ev.priors, specs)
        for C in (C_MAIN, COLD_CHUNK):
            part = tuple(x[..., :C].contiguous() for x in nuclei) \
                + args[4:]
            kv, ksw, krf = prep.model_operands(*part)
            pv, psw, prf = prep.model_operands_plain(*part)
            if not torch.equal(kv, pv):
                raise AssertionError('K1 validity differs from its twin on '
                                     '%d chains' % int((kv != pv).sum()))
            log('K1: valid %d/%d, geometry %s' % (
                int(kv.sum()), C, prep.geometry(C, NL, len(specs))))
            err = check_bitwise(torch, '%s, %d chains' % (tag, C),
                                ksw + sum(krf, ()), psw + sum(prf, ()))
            if C == C_MAIN:
                err1 = err
        kv, ksw, krf = prep.model_operands(*args)
        out.append(entry(
            counter, tag, 'prep.cu', 'pallas_prep.py:315', err1, None,
            timed(lambda: prep.model_operands_plain(*args), 3),
            nbytes(*nuclei, kv, *ksw, *sum(krf, ())),
            C_MAIN * (OPS['model_fixed'] + NL * (OPS['model_slot']
                                                 + OPS['rf_flatten_slot'])
                      + len(specs) * (OPS['rf_fixed']
                                      + NL * OPS['rf_t0_slot']
                                      + (NL - 1) * OPS['rf_interface'])),
            timed(calls[counter], KERNEL_REPS)))

    # K4 / K5 on the first counting block of the cold search on the
    # 10,240 grown models (64 candidates above cm at each of the 21
    # periods), and on the cold chunk of initial models (one layer over
    # the halfspace) at the search's three grids; the counting block on
    # the cold chunk by the profiler's device time (last) and the
    # wrapper's by CUDA events
    props, cm, bx, top = ksw
    layers = tuple(props[k * NL:(k + 1) * NL].T.contiguous()
                   for k in range(4))
    spec = ev.specs[0]
    R = spec.omegas.shape[0]
    grown = tuple(x.T.contiguous() for x in planes)
    for iwave, kernel, tag, twin in (
            (2, 'K4', 'K4 Rayleigh secular values', swd.dltar4),
            (1, 'K5', 'K5 Love secular values', swd.dltar1)):
        replaces = 'pallas_secular.py:%d' % (267 if iwave == 2 else 332)
        for counter, lay, grids in (
                (kernel, grown, {'count': secular_grids(
                    torch, grown, spec.omegas)['count']}),
                (kernel + '_cold', cold,
                 secular_grids(torch, cold, spec.omegas))):
            C = lay[0].shape[0]
            top_c = swd.layer_top(lay[0])
            args = lay if iwave == 2 else (lay[0], lay[2], lay[3])
            for name, (c, omega) in grids.items():
                k = secular_call(lay, c, omega, iwave)()
                p = twin(omega / c, omega, *args)
                shape = 'x'.join(map(str, k.shape))
                err = check_bitwise(
                    torch, '%s, %s grid, %s candidates, tops %d..%d, '
                    '|values| up to %.3g' % (
                        tag, name, shape, int(top_c.min()),
                        int(top_c.max()), float(p.abs().max())), (k,), (p,))
                geo = swd.geometry(C, R, k.shape[-1] if k.ndim == 3 else 1,
                                   NL, iwave)
                log('%s, %s grid %s: geometry %s, %d shared bytes a block, '
                    '%d resident warps per SM (occupancy calculator), '
                    '%.4f of (warp, layer) pairs split between the '
                    'propagating and the evanescent branch'
                    % (tag, name, shape, geo, geo.smem,
                       swd.resident_warps(geo, iwave),
                       regime_split(torch, lay, c, omega, iwave)))
                if name != 'count':
                    continue
                call = secular_call(lay, c, omega, iwave)
                cold_rec = counter.endswith('_cold')
                events = timed(call, KERNEL_REPS)
                out.append(entry(
                    counter, tag + (' (cold chunk)' if cold_rec else ''),
                    'secular.cu', replaces, err,
                    None if cold_rec else events,
                    timed(lambda: twin(omega / c, omega, *args), 3),
                    nbytes(c, spec.omegas, k, *args),
                    secular_ops(top_c, R * swd.KBLOCK, iwave),
                    events if cold_rec else None))

    # K2 for both wave types
    for iwave, counter, tag in (
            (2, 'K2_rayleigh', 'K2 warm root walker (Rayleigh)'),
            (1, 'K2_love', 'K2 warm root walker (Love)')):
        c_prev, slopes = warm_starts(torch, layers, spec.periods, iwave)
        out.append(check_walker(torch, counter, tag, iwave,
                                (props, spec.omegas, c_prev, cm, bx, top),
                                slopes))

    # K6 for both waves; K3 at the warm path's Gauss-cut lanes on K1's P
    # and S operand sets, and on K6's at all nsamp/2 + 1 lanes, as the
    # cold evaluation runs them
    pspec, sspec = ev.specs[1], ev.specs[2]
    k6 = {}
    for wave in (rf.P_WAVE, rf.SV_WAVE):
        k6[wave] = prep.rf_operands(*planes, pspec.p_skm, wave)
        err6 = check_bitwise(torch, 'K6 RF operands (%s)' % 'PS'[wave],
                             k6[wave], prep.rf_operands_plain(
                                 *planes, pspec.p_skm, wave))
    cplanes = tuple(x.T.contiguous() for x in cold)
    for wave in (rf.P_WAVE, rf.SV_WAVE):
        k6c = prep.rf_operands(*cplanes, pspec.p_skm, wave)
        check_bitwise(torch, 'K6 RF operands (%s, %d-chain cold chunk)'
                      % ('PS'[wave], COLD_CHUNK), k6c, prep.rf_operands_plain(
                          *cplanes, pspec.p_skm, wave))
    k6c = prep.rf_operands(*cplanes, pspec.p_skm)
    for counter, tag, pl, outs, C in (
            ('K6', 'K6 RF operands', planes, k6[rf.P_WAVE], C_MAIN),
            ('K6_cold', 'K6 RF operands (cold chunk)', cplanes, k6c,
             COLD_CHUNK)):
        log('%s: geometry %s' % (tag, prep.geometry(C, NL, 1, False)))
        out.append(entry(
            counter, tag, 'prep.cu', 'pallas_prep.py:141', err6, None,
            timed(lambda: prep.rf_operands_plain(*pl, pspec.p_skm), 3),
            nbytes(*pl, *outs),
            C * (OPS['rf_fixed'] + NL * (OPS['rf_flatten_slot']
                                         + OPS['rf_t0_slot'])
                 + (NL - 1) * OPS['rf_interface']),
            timed(calls[counter], KERNEL_REPS)))
    depth_row = rf.pack_offsets(NL)['depth']
    for (coefs, pack), cut, wave, counter, tag in (
            (krf[0], pspec.cut, rf.P_WAVE, 'K3_warm',
             'K3 RF response (%d lanes, warm)'),
            (k6[rf.P_WAVE], pspec.nsamp // 2 + 1, rf.P_WAVE, 'K3_cold',
             'K3 RF response (%d lanes, cold)'),
            (krf[1], sspec.cut, rf.SV_WAVE, 'K3_sv',
             'K3 RF response (%d lanes, warm, SV)')):
        tag = tag % cut
        rargs = (coefs, pack, cut, pspec.nsamp, pspec.fsamp, wave)
        err3 = check_bitwise(torch, tag, resp.resp(*rargs),
                             resp.resp_plain(*rargs))
        depth = pack[depth_row].clamp(max=NL - 2).double()
        out.append(entry(
            counter, tag, 'resp.cu', 'pallas_rf.py:288', err3,
            timed(lambda: resp.resp(*rargs), KERNEL_REPS),
            timed(lambda: resp.resp_plain(*rargs), 3),
            nbytes(pack, *resp.resp(*rargs))
            + 4 * 32 * C_MAIN * float((depth + 1).mean()),
            cut * float((OPS['resp_fixed']
                         + depth * OPS['resp_layer']).sum())))
        log_resp_lane_work(resp, tag, cut, depth, False)

    # K3r on path A's inputs: K6's operands of the grown models, the
    # seeded per-layer Q planes, the Gauss-cut lanes
    (h, vp, vs, rho), qp, qs = grown_layers(torch, dev)
    qp, qs = qp.T.contiguous(), qs.T.contiguous()
    cut = rf.gauss_cut(512, 5.0, 1.0)
    for wave, counter in ((rf.P_WAVE, 'K3r_p'), (rf.SV_WAVE, 'K3r_sv')):
        tag = 'K3r RF response, per-layer Q (%d lanes, %s)' % (
            cut, 'PS'[wave])
        coefs, pack = prep.rf_operands(
            *(x.T.contiguous() for x in (h, vp, vs, rho)),
            6.4 * rf.DEG_PER_KM, wave)
        rargs = (coefs, pack, qp, qs, cut, 512, 5.0, wave)
        err = check_bitwise(torch, tag, resp.resp_q(*rargs),
                            resp.resp_q_plain(*rargs))
        depth = rf.q_depth(pack[depth_row], qp, qs).clamp(
            max=NL - 2).double()
        out.append(entry(
            counter, tag, 'resp.cu', 'pallas_rf.py:288', err,
            timed(lambda: resp.resp_q(*rargs), KERNEL_REPS),
            timed(lambda: resp.resp_q_plain(*rargs), 3),
            nbytes(pack, qp, qs, *resp.resp_q(*rargs))
            + 4 * 32 * C_MAIN * float((depth + 1).mean()),
            cut * float((OPS['resp_fixed'] + NL * OPS['resp_q_slot']
                         + 2 * OPS['resp_q_phase'] + depth
                         * (OPS['resp_layer'] + 2 * OPS['resp_q_phase'])
                         ).sum())))
        log_resp_lane_work(resp, tag, cut, depth, True)
    return out


def cold_chunk(torch, dev):
    """(C, NL) layer arrays h, vp, vs, rho of one cold-init chunk:
    ``COLD_CHUNK`` initial models as ``tutorial``'s
    ``init_states_host`` draws them (seed 0; one layer over the
    halfspace under ``bench_config.PRIORS``)."""
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.ops import voronoi
    sampler, _ = bench_config.build(dev, iters=ITERS, nl=NL)
    states, _ = sampler.init_states_host(0, COLD_CHUNK)
    return voronoi.voronoi_to_layers(states.vs, states.z, states.n,
                                     states.vpvs)


def log_resp_lane_work(resp, tag, cut, depth, q):
    """Logs K3's or K3r's geometry and executed-per-useful layer-lanes
    under the kernel's lane map (a tile's lanes in order, warps
    straddling two chains)."""
    done, use = resp.lane_work(C_MAIN, cut, NL, depth.cpu().numpy(), q)
    log('%s: geometry %s, executed / useful layer-lanes %.4f'
        % (tag, resp.geometry(C_MAIN, cut, NL, q), done / use))


def check_ragged(torch, dev):
    """The redesigned K2, K3, K3r, K4 and K5 against their twins bit for
    bit at the ragged shapes of tests/test_torch_cuda.py: C = 1, 37,
    10,237 chains, R = 1, 21, 60 periods (K2, both waves, the three move
    classes), F = 1, 99, 257 lanes (K3 and K3r, P and SV); C = 1, 7,
    2,051 chains of 2, 21 and 64 layer slots, 21 or 60 periods of 1, 17
    or 64 candidates (K4 and K5, into NaN-filled memory)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, 'tests'))
    import test_torch_cuda as cases
    t0 = time.perf_counter()
    n = 0
    for C in (1, 37, 10237):
        for R in (1, 21, 60):
            for iwave in (2, 1):
                cases.test_walker_ragged_shapes_bitwise(dev, C, R, iwave)
                n += 1
        for F in (1, 99, 257):
            for q in (False, True):
                cases.test_response_ragged_shapes_bitwise(dev, C, F, q)
                n += 1
    for C in (1, 7, 2051):
        for R, K in cases.SECULAR_SHAPES:
            for nl in (2, 21, 64):
                cases.test_secular_ragged_shapes_bitwise(dev, C, R, K, nl)
                n += 1
    log('ragged shapes: %d K2, K3/K3r and K4/K5 cases bit for bit equal to '
        'their twins in %.1f s' % (n, time.perf_counter() - t0))


def tutorial_layers(torch, dev):
    """The tutorial truth model (tests/conftest.py tutorial_model) as
    (NL, 1) planes h, vp, vs, rho."""
    h = np.zeros((NL, 1), np.float32)
    h[:3, 0] = [5., 23., 8.]
    vs = np.full((NL, 1), 4.4, np.float32)
    vs[:4, 0] = [2.7, 3.6, 3.8, 4.4]
    vp = vs * np.float32(1.73)
    rho = vp * np.float32(0.32) + np.float32(0.77)
    return tuple(torch.tensor(x, device=dev) for x in (h, vp, vs, rho))


def check_golden(torch, dev):
    """The tutorial truth model against the committed golden data:
    cold phase velocities of both wave types (K4, K5), the cold P and S
    receiver functions (K6, K3 over all frequencies), then warm phase
    velocities (K2, each move setting from a warm start off the DDC
    grid), the warm receiver functions (K1's RF rows are K6's; K3 over
    the Gauss-cut lanes), and ``rf.synrf`` with uniform Q given as
    arrays (K6, K3r)."""
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.ops import prep, resp, rf, swd, walk

    fx = bench_config.FIXTURES
    h, vp, vs, rho = tutorial_layers(torch, dev)
    props = torch.cat([h, vp, vs, rho]).contiguous()
    cm, bx = swd.lower_bound(vp, vs, dim=0)
    top = torch.tensor([2.0], device=dev)
    errs = {}
    for name, iwave in (('rdispph', 2), ('ldispph', 1)):
        obs = np.loadtxt(os.path.join(fx, 'st3_%s.dat' % name))
        periods = obs[:, 0].astype(np.float32)
        cg, err, roots, slopes = swd.surfdisp_roots_cold(
            h.T, vp.T, vs.T, rho.T, periods, iwave)
        if bool(err.any()):
            raise AssertionError('cold %s solve of the tutorial model '
                                 'failed' % name)
        errs['cold ' + name] = float(np.abs(cg[0].cpu().numpy()
                                            - obs[:, 1]).max())
        omegas = swd.angular_frequencies(periods, dev)
        worst = 0.0
        for st in (swd.WARM_VS, swd.WARM_Z, swd.WARM_DIM):
            c, found, _ = walk.warm_roots_walk(
                props, omegas, (roots + 0.0013).contiguous(), cm, bx, top,
                st['ring'], swd.WARM_CAP, st['nbisect'], st['newton_iters'],
                swd.NEWTON_MAXSHIFT,
                slope_prev=slopes if st['cached_slope'] else None,
                iwave=iwave)
            if not bool(found.all()):
                raise AssertionError('K2 lost a root of the tutorial model')
            worst = max(worst, float(np.abs(c[0].cpu().numpy()
                                            - obs[:, 1]).max()))
        errs['warm ' + name] = worst

    nsamp, fsamp, tshift = 512, 5.0, 5.0
    cut = rf.gauss_cut(nsamp, fsamp, 1.0)
    dft = rf.dft_tables(cut, nsamp, fsamp, tshift, 1.0, dev)
    q_errs = {}
    for name, wave in (('prf', rf.P_WAVE), ('srf', rf.SV_WAVE)):
        obs = np.loadtxt(os.path.join(fx, 'st3_%s.dat' % name))[:201, 1]
        coefs, pack = prep.rf_operands(h, vp, vs, rho, 6.4 * rf.DEG_PER_KM,
                                       wave)
        for key, lanes, tables in (('cold', nsamp // 2 + 1, None),
                                   ('warm', cut, dft)):
            response = resp.resp(coefs, pack, lanes, nsamp, fsamp, wave)
            y = rf.receiver_function(response, pack, NL, nsamp, fsamp,
                                     tshift, 1.0, tables, wave)
            errs['%s %s' % (key, name)] = float(np.abs(
                y[0, :201].cpu().numpy() - obs).max())
        # K3r: uniform Q as per-layer arrays
        vs0 = float(vs[0, 0])
        vpvs0 = float(vp[0, 0]) / vs0
        fz, fr, y = rf.synrf(h[:, 0], vp[:, 0], vs[:, 0], rho[:, 0],
                             torch.full((NL,), 500.0, device=dev),
                             torch.full((NL,), 225.0, device=dev), 6.4,
                             1.0, nsamp, fsamp, tshift, vs0,
                             (2.0 - vpvs0 ** 2) / (2.0 - 2.0 * vpvs0 ** 2),
                             wave_type=wave)
        if not all(x.shape == (nsamp,) and bool(torch.isfinite(x).all())
                   for x in (fz, fr, y)):
            raise AssertionError('synrf (%s): traces not finite of shape '
                                 '(%d,)' % (name, nsamp))
        q_errs['synrf array-Q ' + name] = float(np.abs(
            y[:201].cpu().numpy() - obs).max())
    log('golden: tutorial model max |err| ' + json.dumps(errs)
        + ' (limit 1e-4 each); ' + json.dumps(q_errs) + ' (limit 5e-4 '
        'each, the f32 bound of tests/test_rf.py:50-54)')
    if not (all(e <= 1e-4 for e in errs.values())
            and all(e <= 5e-4 for e in q_errs.values())):
        raise AssertionError('the kernels miss the tutorial golden data')


def launch_counts():
    """The launch counts of every kernel wrapper: K2's split by wave,
    K3's and K3r's SV launches beside all their launches."""
    from bayhunter_tpu_torch.ops import prep, resp, swd, walk
    w = walk.warm_roots_walk
    return dict(K1=prep.model_operands.launches,
                K2_rayleigh=w.launches - w.love_launches,
                K2_love=w.love_launches, K3=resp.resp.launches,
                K3_sv=resp.resp.sv_launches, K3r=resp.resp_q.launches,
                K3r_sv=resp.resp_q.sv_launches,
                K4=swd.secular4.launches, K5=swd.secular1.launches,
                K6=prep.rf_operands.launches)


def reset_counts():
    from bayhunter_tpu_torch.ops import prep, resp, swd, walk
    for w in (prep.model_operands, walk.warm_roots_walk, resp.resp,
              resp.resp_q, swd.secular4, swd.secular1, prep.rf_operands):
        w.launches = 0
    walk.warm_roots_walk.love_launches = 0
    resp.resp.sv_launches = 0
    resp.resp_q.sv_launches = 0


def main_path(torch, dev, name, build, kernels):
    """One configuration through the port's entry points, with the
    launch counts set to 0 before and read after; fails unless each of
    ``kernels`` launched and K3 launched once per RF target for each K1
    launch of the steps.  Returns (launches at init, launches in all,
    the number of RF targets, sampler, states, generator)."""
    from bayhunter_tpu_torch.sampler.chain import dispatch_cycles

    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    sampler, ev = build(dev, iters=ITERS, nl=NL)
    n_rf = len(ev.rf_specs)
    t0 = time.perf_counter()
    states, gen = sampler.init_states_host(0, C_MAIN)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    at_init = launch_counts()
    log('%s init: %d chains evaluated cold in %.3f s, launches %s, peak '
        '%.3f GiB, %d chains with a failed forward solve'
        % (name, C_MAIN, t_init, json.dumps(at_init),
           torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           int((states.logL <= -1e14).sum())))
    it = -ITERS
    cel = len(sampler.early_order)
    n_early = int(np.ceil(max(0.0, sampler.early_cutoff - it) / cel)) * cel
    t0 = time.perf_counter()
    states = dispatch_cycles(sampler, states, it, n_early, gen)
    it += n_early
    clen = len(sampler.late_order)
    states = dispatch_cycles(sampler, states, it, 2 * clen, gen)  # warm
    it += 2 * clen
    torch.cuda.synchronize()
    log('%s early phase: %d iterations (+%d warm-up late) in %.2f s'
        % (name, n_early, 2 * clen, time.perf_counter() - t0))
    t0 = time.perf_counter()
    count = LATE_CYCLES * clen
    states = dispatch_cycles(sampler, states, it, count, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    ff = states.fwdfail.sum(0).cpu().numpy()
    pp = states.proposed.sum(0).cpu().numpy()
    acc = states.accepted.sum(0).cpu().numpy()
    stats = dict(
        config=name, init_s=t_init,
        proposals_per_s=count * C_MAIN / dt, iters_timed=count,
        seconds_timed=dt,
        fwd_reject_pct=100.0 * ff.sum() / max(pp.sum(), 1),
        fwd_reject_dim_pct=(100.0 * ff[2] / pp[2]) if pp[2] else None,
        accepted=acc.tolist(), proposed=pp.tolist(),
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        launches=launches)
    log('main path: ' + json.dumps(stats))
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError('%s: kernels %s never launched' % (name,
                                                                missing))
    if launches['K3'] - at_init['K3'] != n_rf * launches['K1']:
        raise AssertionError('%s: K3 launched %d times in the steps, not '
                             '%d per K1 launch' % (
                                 name, launches['K3'] - at_init['K3'], n_rf))
    if not bool(torch.isfinite(states.logL).all()):
        raise AssertionError('non-finite logL')
    if not acc[2] > 0:
        raise AssertionError('no dimension proposal was accepted')
    for t, (y, roots, _) in enumerate(states.cache):
        if not bool(torch.isfinite(y).all()):
            raise AssertionError('non-finite cached synthetics, target %d'
                                 % t)
    return at_init, launches, n_rf, sampler, states, gen


def path_a(torch, dev):
    """Path A: ``rf.synrf_batch`` on 10,240 grown models under the seeded
    per-layer Q model, for P and SV incidence, ``PATH_A_CALLS`` calls
    each, the launch counts set to 0 before and read after.  Checks the
    RFs' shape and finiteness, and 64 chains against the entry point's
    plain twins on the CPU.  Returns the launch counts."""
    from bayhunter_tpu_torch.ops import rf

    (h, vp, vs, rho), qp, qs = grown_layers(torch, dev)
    vpvs0 = vp[:, 0] / vs[:, 0]
    poisson = (2.0 - vpvs0 * vpvs0) / (2.0 - 2.0 * vpvs0 * vpvs0)
    args = (h, vp, vs, rho, qp, qs, 6.4, 1.0, 512, 5.0, 5.0, vs[:, 0],
            poisson)
    reset_counts()
    stats = {}
    for wave in (rf.P_WAVE, rf.SV_WAVE):
        seconds = []
        for _ in range(PATH_A_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = rf.synrf_batch(*args, wave_type=wave)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        if not (y.shape == (C_MAIN, 512) and bool(torch.isfinite(y).all())):
            raise AssertionError('path A: RFs of shape %s, finite %s'
                                 % (tuple(y.shape),
                                    bool(torch.isfinite(y).all())))
        ref = rf.synrf_batch(*(x[:64].cpu() for x in args[:6]), *args[6:11],
                             *(x[:64].cpu() for x in args[11:]),
                             wave_type=wave, device='cpu')
        err = float((y[:64].cpu() - ref).abs().max())
        steady = float(np.median(seconds[1:]))
        stats['PS'[wave]] = dict(
            seconds_per_call=seconds, models_per_s=C_MAIN / steady,
            max_abs_rf=float(y.abs().max()), max_err_vs_cpu_twins=err)
        if not err <= 1e-5:
            raise AssertionError('path A (%s): RFs differ from the CPU '
                                 'twins by %.3g' % ('PS'[wave], err))
    launches = launch_counts()
    log('path A, synrf_batch of %d models, per-layer Q: %s, launches %s'
        % (C_MAIN, json.dumps(stats), json.dumps(launches)))
    if not (launches['K6'] == launches['K3r'] == 2 * PATH_A_CALLS
            and launches['K3r_sv'] == PATH_A_CALLS and launches['K3'] == 0):
        raise AssertionError('path A did not run K6 and K3r once per call')
    return launches


def merged_length(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_steps(torch, sampler, states, gen):
    """Where the late steps' time goes: host-clock ms per step of each
    move (draws included, synchronised), then ``PROFILE_CYCLES`` late
    cycles under torch.profiler — wall time, the device's busy time
    (union of its kernel and copy intervals) and idle share, and each
    kernel's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bayhunter_tpu_torch.sampler import chain

    step_ms = {}
    for name, move in (('vs', chain.MOVE_VS), ('z', chain.MOVE_Z),
                       ('dim', chain.MOVE_DIM),
                       ('noise', chain.MOVE_NOISE)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEP_REPS):
            states = sampler.step(states, move,
                                  sampler.draw(gen, states, move))
        torch.cuda.synchronize()
        step_ms[name] = 1e3 * (time.perf_counter() - t0) / STEP_REPS

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_CYCLES):
            states = sampler.cycle(states, sampler.late_order, gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    if not dev_events:
        raise AssertionError('torch.profiler recorded no device activity')
    busy_ms = 1e-3 * merged_length(
        [(e.time_range.start, e.time_range.end) for e in dev_events])
    kernel_ms = {}
    for tag, name in KERNEL_NAMES.items():
        if tag in WARM_KERNELS:
            kernel_ms[tag] = 1e-3 * sum(e.time_range.elapsed_us()
                                        for e in dev_events
                                        if name in e.name)
    iters = PROFILE_CYCLES * len(sampler.late_order)
    stats = dict(
        step_ms=step_ms, profiled_iters=iters, wall_ms=wall_ms,
        device_busy_ms=busy_ms, device_idle_pct=100.0 * (1.0 - busy_ms
                                                          / wall_ms),
        kernel_device_ms=kernel_ms,
        device_events_per_iter=len(dev_events) / iters)
    log('profile: ' + json.dumps(stats))
    if not all(v > 0.0 for v in kernel_ms.values()):
        raise AssertionError('the profile missed a kernel of the path')


def profile_cold_inits(torch, dev):
    """Each configuration's cold init of ``C_MAIN`` chains: wall time on
    the host clock (synchronised), then once more under torch.profiler
    the device time of K3, K4, K5 and K6 and the device's busy time;
    the host's share of the cold init is the wall time less the busy
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bayhunter_tpu_torch import bench_config

    stats = {}
    for name in ('tutorial', 'tutorial_rl_prf', 'tutorial_prf_srf'):
        sampler, _ = bench_config.build_config(name, dev, iters=ITERS, nl=NL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.init_states_host(0, C_MAIN)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sampler.init_states_host(0, C_MAIN)
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA]
        stats[name] = dict(
            wall_ms=wall_ms, device_busy_ms=1e-3 * merged_length(
                [(e.time_range.start, e.time_range.end)
                 for e in dev_events]),
            kernel_device_ms={k: 1e-3 * sum(
                e.time_range.elapsed_us() for e in dev_events
                if KERNEL_NAMES[k] in e.name)
                for k in ('K3', 'K4', 'K5', 'K6')})
    log('cold init profile: ' + json.dumps(stats))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py needs a CUDA device')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.ops import _ext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log('host: ' + host_cpu())
    _ext.load()
    seconds, build_log = _ext.build_info()
    log('kernels built and loaded in %.1f s' % seconds)
    for line in build_log.splitlines():
        if 'Compiling entry' in line or 'registers' in line \
                or 'spill' in line:
            log('ptxas: ' + line.split('ptxas info    :')[-1].strip())

    kernels = check_kernels(torch, dev)
    check_ragged(torch, dev)
    check_golden(torch, dev)
    by_path = {}
    init_a, all_a, n_rf, sampler, states, gen = main_path(
        torch, dev, 'tutorial', bench_config.build,
        ('K1', 'K2_rayleigh', 'K3', 'K4', 'K6'))
    by_path['tutorial'] = (init_a, all_a, n_rf)
    profile_steps(torch, sampler, states, gen)
    del sampler, states, gen
    init_b, all_b, n_rf, _, _, _ = main_path(
        torch, dev, 'tutorial_rl_prf', bench_config.build_rl_prf,
        ('K1', 'K2_rayleigh', 'K2_love', 'K3', 'K4', 'K5', 'K6'))
    by_path['tutorial_rl_prf'] = (init_b, all_b, n_rf)
    zero = dict.fromkeys(all_b, 0)
    by_path['synrf_batch'] = (zero, path_a(torch, dev), 0)
    init_c, all_c, n_rf, _, _, _ = main_path(
        torch, dev, 'tutorial_prf_srf', bench_config.build_prf_srf,
        ('K1', 'K2_rayleigh', 'K3', 'K3_sv', 'K4', 'K6'))
    by_path['tutorial_prf_srf'] = (init_c, all_c, n_rf)
    # each record's launches on the paths: K1 by its number of RF
    # operand sets; K3 at all frequencies only in the cold inits, at the
    # Gauss-cut ones only in the cycles
    rules = dict(
        K1=lambda i, t, n: t['K1'] if n == 1 else 0,
        K1_2rf=lambda i, t, n: t['K1'] if n == 2 else 0,
        K3_warm=lambda i, t, n: (t['K3'] - t['K3_sv'])
        - (i['K3'] - i['K3_sv']),
        K3_cold=lambda i, t, n: i['K3'] - i['K3_sv'],
        K3_sv=lambda i, t, n: t['K3_sv'] - i['K3_sv'],
        K3r_p=lambda i, t, n: t['K3r'] - t['K3r_sv'],
        K3r_sv=lambda i, t, n: t['K3r_sv'],
        K4_cold=lambda i, t, n: i['K4'], K5_cold=lambda i, t, n: i['K5'],
        K6_cold=lambda i, t, n: i['K6'])
    profile_kernels(torch, dev, kernels)
    profile_cold_inits(torch, dev)
    for k in kernels:
        counter = k.pop('counter')
        rule = rules.get(counter, lambda i, t, n: t[counter])
        per = {path: rule(*counts) for path, counts in by_path.items()}
        k['launches'] = sum(per.values())
        k['launches_by_path'] = per
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
