"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 model operands, K2 warm root
walker, K3 RF response) from ``bayhunter_tpu_torch/csrc`` with nvcc,
checks each against its plain PyTorch twin on the card at the main-path
shapes (10,240 chains, 21 layer slots), checks K2 and K3 on the
tutorial truth model against the committed golden data
(``tests/fixtures/st3_rdispph.dat``, ``st3_prf.dat``), then drives the
main path — the
tutorial joint SWD+RF inversion of ``bench.py`` — through the port's
entry points: cold init of 10,240 chains, early cycles up to the
early cutoff, then timed late cycles.  Last it profiles the late
steps: host-clock time per move, and under ``torch.profiler`` the
device's busy and idle share and each kernel's device time.  It prints
one line per phase (the host CPU among them, since the host-side work
sets the rate), the kernels' JSON line, and last
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
LATE_CYCLES = 64      # timed late cycles
KERNEL_REPS = 20
STEP_REPS = 20        # host-clock steps per move in the profile phase
PROFILE_CYCLES = 4    # late cycles under torch.profiler
KERNEL_NAMES = (('K1', 'prep_kernel'), ('K2', 'walk_kernel'),
                ('K3', 'resp_kernel'))


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


def check_kernels(torch, dev):
    """Each kernel against its twin on the card at main-path shapes."""
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.ops import prep, resp, swd, walk

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
    out.append(dict(name='K1 model operands', route='cuda',
                    source='bayhunter_tpu_torch/csrc/prep.cu',
                    replaces='bayhunter_tpu/ops/pallas_prep.py:315',
                    max_abs_err=err1,
                    ms=timed(lambda: prep.model_operands(*args),
                             KERNEL_REPS),
                    plain_ms=timed(lambda: prep.model_operands_plain(*args),
                                   3)))

    # K2, for each move class, from cold roots moved off the DDC grid
    props, cm, bx, top = ksw
    h, vp, vs_l, rho = (props[k * NL:(k + 1) * NL].T.contiguous()
                        for k in range(4))
    spec = ev.specs[0]
    omegas = spec.omegas
    roots, slopes = [], []
    for i in range(0, C_MAIN, 2048):
        _, _, r_, s_ = swd.surfdisp_roots_cold(
            h[i:i + 2048], vp[i:i + 2048], vs_l[i:i + 2048],
            rho[i:i + 2048], spec.periods)
        roots.append(r_)
        slopes.append(s_)
    roots, slopes = torch.cat(roots), torch.cat(slopes)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    c_prev = roots + 0.0013 + 0.04 * (torch.rand(
        roots.shape, generator=gen, device=dev) - 0.5)
    err2 = 0.0
    k2_ms = k2_plain = 0.0
    for name, st in (('vs', swd.WARM_VS), ('z', swd.WARM_Z),
                     ('dim', swd.WARM_DIM)):
        kw = dict(ring_k=st['ring'], trips=swd.WARM_CAP,
                  nbisect=st['nbisect'], newton_iters=st['newton_iters'],
                  newton_maxshift=swd.NEWTON_MAXSHIFT,
                  slope_prev=slopes if st['cached_slope'] else None)
        wargs = (props, omegas, c_prev, cm, bx, top)
        kc, kf, ks = walk.warm_roots_walk(*wargs, **kw)
        pc, pf, ps = walk.warm_roots_walk_plain(*wargs, **kw)
        torch.cuda.synchronize()
        flips = float((kf != pf).float().mean())
        both = kf & pf
        d = (kc - pc).abs()[both]
        p90 = float(torch.quantile(d.float(), 0.9)) if d.numel() else 0.0
        dmax = float(d.max()) if d.numel() else 0.0
        err2 = max(err2, dmax)
        log('K2 walker (%s moves): found %.4f, found flags differ on '
            '%.2e of lanes (limit 1e-4), root p90 %.3g (limit 2e-5), '
            'max %.3g (limit 5e-4)' % (name, float(kf.float().mean()),
                                       flips, p90, dmax))
        if not (flips <= 1e-4 and p90 < 2e-5 and dmax < 5e-4):
            raise AssertionError('K2 differs from its twin')
        k2_ms += timed(lambda: walk.warm_roots_walk(*wargs, **kw),
                       KERNEL_REPS)
        k2_plain += timed(lambda: walk.warm_roots_walk_plain(*wargs,
                                                             **kw), 2)
    out.append(dict(name='K2 warm root walker', route='cuda',
                    source='bayhunter_tpu_torch/csrc/walk.cu',
                    replaces='bayhunter_tpu/ops/pallas_walk.py:71',
                    max_abs_err=err2, ms=k2_ms / 3, plain_ms=k2_plain / 3))

    # K3
    coefs, pack = krf
    rspec = ev.specs[1]
    rargs = (coefs, pack, rspec.cut, rspec.nsamp, rspec.fsamp)
    ko = resp.resp(*rargs)
    po = resp.resp_plain(*rargs)
    torch.cuda.synchronize()
    scale = float(torch.maximum(po[0].abs().max(), po[1].abs().max()))
    err3 = max(float((a - b).abs().max()) for a, b in zip(ko, po))
    log('K3 RF response: max |kernel - twin| = %.3g, limit 1e-5 x max|cz| '
        '= %.3g' % (err3, 1e-5 * scale))
    if not err3 <= 1e-5 * scale:
        raise AssertionError('K3 differs from its twin')
    out.append(dict(name='K3 RF response', route='cuda',
                    source='bayhunter_tpu_torch/csrc/resp.cu',
                    replaces='bayhunter_tpu/ops/pallas_rf.py:288',
                    max_abs_err=err3,
                    ms=timed(lambda: resp.resp(*rargs), KERNEL_REPS),
                    plain_ms=timed(lambda: resp.resp_plain(*rargs), 3)))
    return out


def check_golden(torch, dev):
    """The tutorial truth model (tests/conftest.py tutorial_model)
    through K2, for each move setting from a warm start off the DDC
    grid, and through K3, against the committed golden data."""
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.ops import prep, resp, rf, swd, walk

    obs_swd = np.loadtxt(os.path.join(bench_config.FIXTURES,
                                      'st3_rdispph.dat'))
    obs_rf = np.loadtxt(os.path.join(bench_config.FIXTURES,
                                     'st3_prf.dat'))[:201, 1]
    h = np.zeros((NL, 1), np.float32)
    h[:3, 0] = [5., 23., 8.]
    vs = np.full((NL, 1), 4.4, np.float32)
    vs[:4, 0] = [2.7, 3.6, 3.8, 4.4]
    vp = vs * np.float32(1.73)
    rho = vp * np.float32(0.32) + np.float32(0.77)
    h, vp, vs, rho = (torch.tensor(x, device=dev) for x in (h, vp, vs, rho))

    periods = obs_swd[:, 0].astype(np.float32)
    _, err, roots, slopes = swd.surfdisp_roots_cold(h.T, vp.T, vs.T, rho.T,
                                                    periods)
    if bool(err.any()):
        raise AssertionError('cold solve of the tutorial model failed')
    props = torch.cat([h, vp, vs, rho]).contiguous()
    cm, bx = swd.lower_bound(vp, vs, dim=0)
    top = torch.tensor([2.0], device=dev)
    omegas = swd.angular_frequencies(periods, dev)
    worst = 0.0
    for st in (swd.WARM_VS, swd.WARM_Z, swd.WARM_DIM):
        c, found, _ = walk.warm_roots_walk(
            props, omegas, (roots + 0.0013).contiguous(), cm, bx, top,
            st['ring'], swd.WARM_CAP, st['nbisect'], st['newton_iters'],
            swd.NEWTON_MAXSHIFT,
            slope_prev=slopes if st['cached_slope'] else None)
        if not bool(found.all()):
            raise AssertionError('K2 lost a root of the tutorial model')
        worst = max(worst, float(np.abs(c[0].cpu().numpy()
                                        - obs_swd[:, 1]).max()))

    coefs, pack = prep.rf_operands_plain(h, vp, vs, rho, 6.4 * rf.DEG_PER_KM)
    nsamp, fsamp, tshift = 512, 5.0, 5.0
    cut = rf.gauss_cut(nsamp, fsamp, 1.0)
    response = resp.resp(coefs, pack, cut, nsamp, fsamp)
    y = rf.receiver_function(response, pack, NL, nsamp, fsamp, tshift, 1.0,
                             dft=rf.dft_tables(cut, nsamp, fsamp, tshift,
                                               1.0, dev))
    err_rf = float(np.abs(y[0, :201].cpu().numpy() - obs_rf).max())
    log('golden: tutorial model, K2 phase velocities max |err| = %.3g, '
        'K3 receiver function max |err| = %.3g (limit 1e-4 each)'
        % (worst, err_rf))
    if not (worst <= 1e-4 and err_rf <= 1e-4):
        raise AssertionError('the kernels miss the tutorial golden data')


def main_path(torch, dev):
    """The bench.py configuration through the port's entry points."""
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.ops import prep, resp, walk
    from bayhunter_tpu_torch.sampler.chain import dispatch_cycles

    wrappers = (prep.model_operands, walk.warm_roots_walk, resp.resp)
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    sampler, _ = bench_config.build(dev, iters=ITERS, nl=NL)
    t0 = time.perf_counter()
    states, gen = sampler.init_states_host(0, C_MAIN)
    torch.cuda.synchronize()
    log('init: %d chains evaluated cold in %.2f s'
        % (C_MAIN, time.perf_counter() - t0))
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
    log('early phase: %d iterations (+%d warm-up late) in %.2f s'
        % (n_early, 2 * clen, time.perf_counter() - t0))
    t0 = time.perf_counter()
    count = LATE_CYCLES * clen
    states = dispatch_cycles(sampler, states, it, count, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [w.launches for w in wrappers]
    ff = states.fwdfail.sum(0).cpu().numpy()
    pp = states.proposed.sum(0).cpu().numpy()
    acc = states.accepted.sum(0).cpu().numpy()
    rate = count * C_MAIN / dt
    stats = dict(
        proposals_per_s=rate, iters_timed=count, seconds_timed=dt,
        fwd_reject_pct=100.0 * ff.sum() / max(pp.sum(), 1),
        fwd_reject_dim_pct=(100.0 * ff[2] / pp[2]) if pp[2] else None,
        accepted=acc.tolist(), proposed=pp.tolist(),
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        launches=dict(zip(('K1', 'K2', 'K3'), launches)))
    log('main path: ' + json.dumps(stats))
    if not all(n > 0 for n in launches):
        raise AssertionError('a kernel of the main path never launched')
    if not bool(torch.isfinite(states.logL).all()):
        raise AssertionError('non-finite logL')
    if not acc[2] > 0:
        raise AssertionError('no dimension proposal was accepted')
    for t, (y, roots, _) in enumerate(states.cache):
        if not bool(torch.isfinite(y).all()):
            raise AssertionError('non-finite cached synthetics, target %d'
                                 % t)
    return launches, sampler, states, gen


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
        kernel_ms[tag] = 1e-3 * sum(e.time_range.elapsed_us()
                                    for e in dev_events if name in e.name)
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
    launches, sampler, states, gen = main_path(torch, dev)
    profile_steps(torch, sampler, states, gen)
    for k, n in zip(kernels, launches):
        k['launches'] = n
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
