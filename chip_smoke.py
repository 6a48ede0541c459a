"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``bayhunter_tpu_torch/csrc`` with
nvcc (one process per source, started together): K1 model operands, K2
warm root walker (Rayleigh and Love), K3 RF response, K4/K5 Rayleigh
and Love secular values, K6 RF operands.  Checks each against its plain
PyTorch twin on the card at the main paths' shapes (10,240 chains, 21
layer slots; K4/K5 on one 64-candidate counting block of 21 periods,
K3 at the warm 99 and the cold 257 frequencies), timing both with CUDA
events beside the kernel's bound (the larger of its bytes over
3.35 TB/s and its operations over 67 TFLOP/s, the H100's float32
peak, counted from this run's inputs).  Checks the tutorial truth model
against the committed golden data (``tests/fixtures/st3_*.dat``): the
cold Rayleigh and Love solves (K4, K5), the cold receiver function (K6,
K3 at 257 frequencies), the warm walker for both wave types (K2) and
the warm receiver function (K3).

Then it drives two main paths through the port's entry points, each
with every launch count set to 0 just before it and read just after:

  * ``tutorial`` — ``bench.py``'s tutorial joint inversion (Rayleigh
    phase + P-RF): cold init of 10,240 chains (K4, K6, K3), early
    cycles up to the early cutoff, timed late cycles (K1, K2, K3);
  * ``tutorial_rl_prf`` — the same with Love phase as a third target:
    cold init (K4, K5, K6, K3), early cycles, timed late cycles (K1,
    K2 for both wave types, K3).

Last it profiles the late steps of ``tutorial``: host-clock time per
move, and under ``torch.profiler`` the device's busy and idle share and
each kernel's device time.  It prints one line per phase (the host CPU
among them, since the host-side work sets the rate), the card's name
and power limit, the kernels' JSON line, and last
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
KERNEL_REPS = 20
STEP_REPS = 20        # host-clock steps per move in the profile phase
PROFILE_CYCLES = 4    # late cycles under torch.profiler
# device kernel names, as the profiler lists them
KERNEL_NAMES = (('K1', '::prep_kernel('), ('K2', 'walk_kernel'),
                ('K3', 'resp_kernel'), ('K4', 'secular_kernel<2>'),
                ('K5', 'secular_kernel<1>'), ('K6', 'rf_prep_kernel'))
WARM_KERNELS = ('K1', 'K2', 'K3')     # the kernels of a late step

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
    rf_interface=420,     # cplx.cuh interface_coeffs + skip-depth test
    rf_slot=25,           # flattening (two logs) and t0 of one slot
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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def entry(counter, name, source, replaces, err, ms, plain_ms, moved, ops):
    """One kernel's record of the JSON line: ``moved`` bytes (each input
    read once, each output written once) and ``ops`` float32 operations
    that this run's inputs need give the bound; ``counter`` names its
    launch count in :func:`launch_counts`."""
    t_bytes = 1e3 * moved / PEAK_BYTES
    t_ops = 1e3 * ops / PEAK_FLOPS
    return dict(counter=counter, name=name, route='cuda',
                source='bayhunter_tpu_torch/csrc/' + source,
                replaces='bayhunter_tpu/ops/' + replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                bound_share=max(t_bytes, t_ops) / ms, library_ms=None)


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


def check_walker(torch, counter, name, iwave, wargs, slopes):
    """K2 for one wave type against its twin, for each move class:
    (record, max error).  The bound counts the secular evaluations each
    lane makes (the twin counts them)."""
    from bayhunter_tpu_torch.ops import swd, walk

    props, omegas, c_prev, cm, bx, top = wargs
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
        log('%s (%s moves): found %.4f, found flags differ on %.2e of '
            'lanes (limit 1e-4), root p90 %.3g (limit 2e-5), max %.3g '
            '(limit 5e-4), bitwise %s, %.2f evaluations per lane'
            % (name, move, float(kf.float().mean()), flips, p90, dmax,
               bitwise, float(evals.double().mean())))
        if not (flips <= 1e-4 and p90 < 2e-5 and dmax < 5e-4):
            raise AssertionError('%s differs from its twin' % name)
        ms += timed(lambda: walk.warm_roots_walk(*wargs, **kw), KERNEL_REPS)
        plain_ms += timed(lambda: walk.warm_roots_walk_plain(*wargs, **kw),
                          2)
        moved += nbytes(props, omegas, c_prev, cm, bx, top, sl, kc, kf, ks)
        ops += secular_ops(top.clamp(max=NL - 2), evals.double(), iwave)
        ops += OPS['walk_eval'] * float(evals.double().sum())
    return entry(counter, name, 'walk.cu', 'pallas_walk.py:71', err, ms / 3,
                 plain_ms / 3, moved / 3, ops / 3)


def check_kernels(torch, dev):
    """Each kernel against its twin on the card at main-path shapes."""
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.ops import prep, resp, rf, swd, walk

    sampler, ev = bench_config.build(dev, iters=ITERS, nl=NL)
    VS, Z, N = grown_models(C_MAIN, NL)
    vs_t = torch.tensor(VS.T.copy(), device=dev)
    z_t = torch.tensor(Z.T.copy(), device=dev)
    n = torch.tensor(N, device=dev)
    vpvs = torch.full((C_MAIN,), 1.73, dtype=torch.float32, device=dev)
    out = []

    # K1
    args = (vs_t, z_t, n, vpvs, ev.priors, ev.p_skm)
    kv, ksw, krf = prep.model_operands(*args)
    pv, psw, prf = prep.model_operands_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(kv, pv):
        raise AssertionError('K1 validity differs from its twin on %d '
                             'chains' % int((kv != pv).sum()))
    err1 = max(float((a - b).abs().max()) for a, b in
               zip(ksw + krf, psw + prf))
    log('K1 model operands: valid %d/%d, max |kernel - twin| = %.3g '
        '(tolerance 3e-6)' % (int(kv.sum()), C_MAIN, err1))
    if not err1 <= 3e-6:
        raise AssertionError('K1 operands differ from the twin')
    out.append(entry(
        'K1', 'K1 model operands', 'prep.cu', 'pallas_prep.py:315', err1,
        timed(lambda: prep.model_operands(*args), KERNEL_REPS),
        timed(lambda: prep.model_operands_plain(*args), 3),
        nbytes(vs_t, z_t, n, vpvs, kv, *ksw, *krf),
        C_MAIN * (OPS['model_fixed'] + OPS['rf_fixed']
                  + NL * (OPS['model_slot'] + OPS['rf_slot'])
                  + (NL - 1) * OPS['rf_interface'])))

    # K4 / K5 on the first counting block of the cold search (64
    # candidates above cm at each of the 21 periods)
    props, cm, bx, top = ksw
    layers = tuple(props[k * NL:(k + 1) * NL].T.contiguous()
                   for k in range(4))
    spec = ev.specs[0]
    omega = swd.angular_frequencies(spec.periods, dev)[None, :, None]
    koff = torch.arange(1, swd.KBLOCK + 1, device=dev) * swd.DDC
    wvno = omega / (cm[:, None, None] + koff)
    R = omega.shape[1]
    cand_top = swd.layer_top(layers[0])
    for iwave, counter, tag, twin in (
            (2, 'K4', 'K4 Rayleigh secular values', swd.dltar4),
            (1, 'K5', 'K5 Love secular values', swd.dltar1)):
        lay = layers if iwave == 2 else (layers[0], layers[2], layers[3])

        def kernel():
            return swd.secular_values(wvno, omega, *layers, iwave)

        def plain():
            return twin(wvno, omega, *lay)

        k, p = kernel(), plain()
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        log('%s: %d x %d x %d candidates, max |kernel - twin| = %.3g '
            '(bitwise required), |values| up to %.3g'
            % (tag, C_MAIN, R, swd.KBLOCK, err, float(p.abs().max())))
        if not (bool(torch.isfinite(k).all()) and torch.equal(k, p)):
            raise AssertionError('%s differ from the twin' % tag)
        out.append(entry(
            counter, tag, 'secular.cu', 'pallas_secular.py:%d'
            % (267 if iwave == 2 else 332), err,
            timed(kernel, KERNEL_REPS), timed(plain, 3),
            nbytes(wvno, omega, k, *lay),
            secular_ops(cand_top, R * swd.KBLOCK, iwave)))

    # K2 for both wave types, from cold roots (K4, K5) moved off the
    # DDC grid
    gen = torch.Generator(device=dev)
    for iwave, counter, tag in (
            (2, 'K2_rayleigh', 'K2 warm root walker (Rayleigh)'),
            (1, 'K2_love', 'K2 warm root walker (Love)')):
        roots, slopes = [], []
        for i in range(0, C_MAIN, 2048):
            _, _, r_, s_ = swd.surfdisp_roots_cold(
                *(x[i:i + 2048] for x in layers), spec.periods, iwave)
            roots.append(r_)
            slopes.append(s_)
        roots, slopes = torch.cat(roots), torch.cat(slopes)
        gen.manual_seed(11)
        c_prev = roots + 0.0013 + 0.04 * (torch.rand(
            roots.shape, generator=gen, device=dev) - 0.5)
        out.append(check_walker(torch, counter, tag, iwave,
                                (props, spec.omegas, c_prev, cm, bx, top),
                                slopes))

    # K3 at the warm path's Gauss-cut lanes, on K1's operands, and K6 ->
    # K3 at all nsamp/2 + 1 lanes, as the cold evaluation runs them
    rspec = ev.specs[1]
    planes = tuple(props[k * NL:(k + 1) * NL] for k in range(4))
    kc6, kp6 = prep.rf_operands(*planes, ev.p_skm)
    pc6, pp6 = prep.rf_operands_plain(*planes, ev.p_skm)
    torch.cuda.synchronize()
    err6 = max(float((kc6 - pc6).abs().max()),
               float((kp6 - pp6).abs().max()))
    log('K6 RF operands: max |kernel - twin| = %.3g (bitwise required)'
        % err6)
    if not (torch.equal(kc6, pc6) and torch.equal(kp6, pp6)):
        raise AssertionError('K6 differs from its twin')
    out.append(entry(
        'K6', 'K6 RF operands', 'prep.cu', 'pallas_prep.py:141', err6,
        timed(lambda: prep.rf_operands(*planes, ev.p_skm), KERNEL_REPS),
        timed(lambda: prep.rf_operands_plain(*planes, ev.p_skm), 3),
        nbytes(*planes, kc6, kp6),
        C_MAIN * (OPS['rf_fixed'] + NL * OPS['rf_slot']
                  + (NL - 1) * OPS['rf_interface'])))
    depth_row = rf.pack_offsets(NL)['depth']
    for (coefs, pack), cut, counter, tag in (
            (krf, rspec.cut, 'K3_warm', 'K3 RF response (%d lanes, warm)'),
            ((kc6, kp6), rspec.nsamp // 2 + 1, 'K3_cold',
             'K3 RF response (%d lanes, cold)')):
        tag = tag % cut
        rargs = (coefs, pack, cut, rspec.nsamp, rspec.fsamp)
        ko = resp.resp(*rargs)
        po = resp.resp_plain(*rargs)
        torch.cuda.synchronize()
        scale = float(torch.maximum(po[0].abs().max(), po[1].abs().max()))
        err3 = max(float((a - b).abs().max()) for a, b in zip(ko, po))
        bitwise = all(torch.equal(a, b) for a, b in zip(ko, po))
        log('%s: max |kernel - twin| = %.3g, limit 1e-5 x max|cz| = %.3g, '
            'bitwise %s' % (tag, err3, 1e-5 * scale, bitwise))
        if not err3 <= 1e-5 * scale:
            raise AssertionError('K3 differs from its twin')
        depth = pack[depth_row].clamp(max=NL - 2).double()
        out.append(entry(
            counter, tag, 'resp.cu', 'pallas_rf.py:288', err3,
            timed(lambda: resp.resp(*rargs), KERNEL_REPS),
            timed(lambda: resp.resp_plain(*rargs), 3),
            nbytes(pack, *ko) + 4 * 32 * C_MAIN * float((depth + 1).mean()),
            cut * float((OPS['resp_fixed']
                         + depth * OPS['resp_layer']).sum())))
    return out


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
    cold phase velocities of both wave types (K4, K5), the cold receiver
    function (K6, K3 over all frequencies), then warm phase velocities
    (K2, each move setting from a warm start off the DDC grid) and the
    warm receiver function (K1's RF rows are K6's; K3 over the Gauss-cut
    lanes)."""
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.ops import prep, resp, rf, swd, walk

    fx = bench_config.FIXTURES
    obs_rf = np.loadtxt(os.path.join(fx, 'st3_prf.dat'))[:201, 1]
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
    coefs, pack = prep.rf_operands(h, vp, vs, rho, 6.4 * rf.DEG_PER_KM)
    full = resp.resp(coefs, pack, nsamp // 2 + 1, nsamp, fsamp)
    y = rf.receiver_function(full, pack, NL, nsamp, fsamp, tshift, 1.0)
    errs['cold prf'] = float(np.abs(y[0, :201].cpu().numpy()
                                    - obs_rf).max())
    cut = rf.gauss_cut(nsamp, fsamp, 1.0)
    response = resp.resp(coefs, pack, cut, nsamp, fsamp)
    y = rf.receiver_function(response, pack, NL, nsamp, fsamp, tshift, 1.0,
                             dft=rf.dft_tables(cut, nsamp, fsamp, tshift,
                                               1.0, dev))
    errs['warm prf'] = float(np.abs(y[0, :201].cpu().numpy()
                                    - obs_rf).max())
    log('golden: tutorial model max |err| ' + json.dumps(errs)
        + ' (limit 1e-4 each)')
    if not all(e <= 1e-4 for e in errs.values()):
        raise AssertionError('the kernels miss the tutorial golden data')


def launch_counts():
    """The launch counts of every kernel wrapper: K2's split by wave."""
    from bayhunter_tpu_torch.ops import prep, resp, swd, walk
    w = walk.warm_roots_walk
    return dict(K1=prep.model_operands.launches,
                K2_rayleigh=w.launches - w.love_launches,
                K2_love=w.love_launches, K3=resp.resp.launches,
                K4=swd.secular4.launches, K5=swd.secular1.launches,
                K6=prep.rf_operands.launches)


def reset_counts():
    from bayhunter_tpu_torch.ops import prep, resp, swd, walk
    for w in (prep.model_operands, walk.warm_roots_walk, resp.resp,
              swd.secular4, swd.secular1, prep.rf_operands):
        w.launches = 0
    walk.warm_roots_walk.love_launches = 0


def main_path(torch, dev, name, build, kernels):
    """One configuration through the port's entry points, with the
    launch counts set to 0 before and read after; fails unless each of
    ``kernels`` launched.  Returns (launches at init, launches in all,
    sampler, states, generator)."""
    from bayhunter_tpu_torch.sampler.chain import dispatch_cycles

    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    sampler, _ = build(dev, iters=ITERS, nl=NL)
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
    if not bool(torch.isfinite(states.logL).all()):
        raise AssertionError('non-finite logL')
    if not acc[2] > 0:
        raise AssertionError('no dimension proposal was accepted')
    for t, (y, roots, _) in enumerate(states.cache):
        if not bool(torch.isfinite(y).all()):
            raise AssertionError('non-finite cached synthetics, target %d'
                                 % t)
    return at_init, launches, sampler, states, gen


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
    for tag, name in KERNEL_NAMES:
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
        if 'Compiling entry' in line or 'registers' in line:
            log('ptxas: ' + line.split('ptxas info    :')[-1].strip())

    kernels = check_kernels(torch, dev)
    check_golden(torch, dev)
    by_path = {}
    init_a, all_a, sampler, states, gen = main_path(
        torch, dev, 'tutorial', bench_config.build,
        ('K1', 'K2_rayleigh', 'K3', 'K4', 'K6'))
    by_path['tutorial'] = (init_a, all_a)
    profile_steps(torch, sampler, states, gen)
    del sampler, states, gen
    init_b, all_b, _, _, _ = main_path(
        torch, dev, 'tutorial_rl_prf', bench_config.build_rl_prf,
        ('K1', 'K2_rayleigh', 'K2_love', 'K3', 'K4', 'K5', 'K6'))
    by_path['tutorial_rl_prf'] = (init_b, all_b)
    # K3 runs at all frequencies only in the cold init, at the
    # Gauss-cut ones only in the cycles
    for k in kernels:
        counter = k.pop('counter')
        per = {}
        for path, (at_init, total) in by_path.items():
            if counter == 'K3_cold':
                per[path] = at_init['K3']
            elif counter == 'K3_warm':
                per[path] = total['K3'] - at_init['K3']
            else:
                per[path] = total[counter]
        k['launches'] = sum(per.values())
        k['launches_by_path'] = per
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
