"""Time K1-K6 case by case on one card, and what bit-for-bit parity
with their twins costs them.

    python3 tools/kernel_variants.py [--relax NAME ...] [--tree DIR]
                                     [--rounds N] [--out DIR]

The cases are ``chip_smoke.py``'s inputs: 10,240 grown models, K2 from
their cold roots (both waves; the vs, z and dim settings one case
each), K3 at 99 lanes on K1's P and S operands and at 257 on K6's, K3r
on path A's models and Q, K1 with no, one and two RF targets (no
target: the model part alone), K6 at 10,240 chains and on a cold
chunk, and K4/K5 on the first counting block of the grown models and
of a cold chunk (trees whose K4/K5 take phase velocities).  Each case
is held against its
plain twin (bitwise equality, max |error| where both are finite, K2's
found-flag flips) and timed with CUDA events over chip_smoke.py's
``KERNEL_REPS`` launches, ``--rounds`` times; K1, K4, K5 and K6 also by
the profiler's device time (median of the launches).  Prints one JSON
line per build: its ptxas lines (registers, spills) and each case's
median and times.

``--tree DIR`` times the port of another tree of the repository (such
as the parent commit, unpacked with ``git archive``) instead of this
one's; ``tools/chip_pair.py`` runs it for each tree in its turns.

``--relax NAME`` (repeatable) also builds this tree's kernels with the
nvcc flags of ``RELAXED[NAME]`` (a library of its own beside the
shipped one, never loaded by the port; its results differ from the
twins') and times the builds in turns within each round: what the
twins' rounding costs — ``fmad`` contracts a*b+c into fused
multiply-adds, ``div`` and ``sqrt`` take the approximate division and
square root, ``fast-math`` all of these with the fast sin, cos and exp.
It writes every build's records to ``DIR/kernel_variants.json``
(``--out``, default ``results/``).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

# nvcc flags in place of the shipped --fmad=false, per relaxed build
RELAXED = {'fmad': ['--fmad=true'],
           'div': ['--fmad=false', '-prec-div=false'],
           'sqrt': ['--fmad=false', '-prec-sqrt=false'],
           'fast-math': ['--use_fast_math']}


def ptxas_lines(library):
    """{kernel entry: 'N registers, ...'} of K1-K6, from the nvcc output
    saved beside ``library`` when it was built."""
    with open(library + '.log') as f:
        log = f.read()
    out, entry = {}, None
    for line in log.splitlines():
        if 'Compiling entry' in line:
            entry = line.split("'")[1]
        elif 'registers' in line and entry is not None:
            if any(k in entry for k in cs.PTXAS_KERNELS):
                out[entry] = line.split('ptxas info    :')[-1].strip()
            entry = None
        elif 'spill' in line and entry is not None:
            out[entry + ' spills'] = line.strip()
    return out


def inputs(torch, dev):
    """name -> (function of the wrappers, its twin, the profiler's name
    of its kernel or None) at chip_smoke.py's shapes."""
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.ops import prep, resp, rf, swd, walk

    _, ev = bench_config.build_prf_srf(dev, iters=cs.ITERS, nl=cs.NL)
    VS, Z, N = cs.grown_models(cs.C_MAIN, cs.NL)
    args = (torch.tensor(VS.T.copy(), device=dev),
            torch.tensor(Z.T.copy(), device=dev), torch.tensor(N, device=dev),
            torch.full((cs.C_MAIN,), 1.73, dtype=torch.float32, device=dev),
            ev.priors, ev.rf_specs)
    _, (props, cm, bx, top), krf = prep.model_operands_plain(*args)
    NL = cs.NL
    layers = tuple(props[k * NL:(k + 1) * NL].T.contiguous()
                   for k in range(4))
    spec, pspec = ev.specs[0], ev.specs[1]
    cases = {}
    for iwave, tag in ((2, 'K2_rayleigh'), (1, 'K2_love')):
        c_prev, slopes = cs.warm_starts(torch, layers, spec.periods, iwave)
        wargs = (props, spec.omegas, c_prev, cm, bx, top)
        for move, st in (('vs', swd.WARM_VS), ('z', swd.WARM_Z),
                         ('dim', swd.WARM_DIM)):
            kw = dict(ring_k=st['ring'], trips=swd.WARM_CAP,
                      nbisect=st['nbisect'], newton_iters=st['newton_iters'],
                      newton_maxshift=swd.NEWTON_MAXSHIFT, iwave=iwave,
                      slope_prev=slopes if st['cached_slope'] else None)
            cases['%s_%s' % (tag, move)] = (
                lambda a=wargs, k=kw: walk.warm_roots_walk(*a, **k),
                lambda a=wargs, k=kw: walk.warm_roots_walk_plain(*a, **k),
                None)
    planes = tuple(props[k * NL:(k + 1) * NL] for k in range(4))
    k6 = prep.rf_operands_plain(*planes, pspec.p_skm, rf.P_WAVE)
    for (coefs, pack), cut, wave, tag in (
            (krf[0], pspec.cut, rf.P_WAVE, 'K3_p_99'),
            (krf[1], pspec.cut, rf.SV_WAVE, 'K3_sv_99'),
            (k6, pspec.nsamp // 2 + 1, rf.P_WAVE, 'K3_p_257')):
        a = (coefs, pack, cut, pspec.nsamp, pspec.fsamp, wave)
        cases[tag] = (lambda a=a: resp.resp(*a),
                      lambda a=a: resp.resp_plain(*a), None)
    (h, vp, vs, rho), qp, qs = cs.grown_layers(torch, dev)
    qp, qs = qp.T.contiguous(), qs.T.contiguous()
    cut = rf.gauss_cut(512, 5.0, 1.0)
    for wave, tag in ((rf.P_WAVE, 'K3r_p_99'), (rf.SV_WAVE, 'K3r_sv_99')):
        coefs, pack = prep.rf_operands_plain(
            *(x.T.contiguous() for x in (h, vp, vs, rho)),
            6.4 * rf.DEG_PER_KM, wave)
        a = (coefs, pack, qp, qs, cut, 512, 5.0, wave)
        cases[tag] = (lambda a=a: resp.resp_q(*a),
                      lambda a=a: resp.resp_q_plain(*a), None)
    for n_rf in (0, 1, 2):
        a = args[:5] + (ev.rf_specs[:n_rf],)
        cases['K1_%drf' % n_rf] = (
            lambda a=a: prep.model_operands(*a),
            lambda a=a: prep.model_operands_plain(*a), cs.KERNEL_NAMES['K1'])
    cold_rows = cs.cold_chunk(torch, dev)
    cold = tuple(x.T.contiguous() for x in cold_rows)
    if hasattr(swd, 'secular_at'):
        for kernel, iwave, twin in (('K4', 2, swd.dltar4),
                                    ('K5', 1, swd.dltar1)):
            for tag, lay in (('count', layers), ('cold', cold_rows)):
                c, om = cs.secular_grids(torch, lay, spec.omegas)['count']
                a = lay if iwave == 2 else (lay[0], lay[2], lay[3])
                cases['%s_%s' % (kernel, tag)] = (
                    cs.secular_call(lay, c, om, iwave),
                    lambda a=a, c=c, om=om, t=twin: t(om / c, om, *a),
                    cs.KERNEL_NAMES[kernel])
    for tag, pl in (('K6_p', planes), ('K6_cold', cold)):
        a = pl + (pspec.p_skm,)
        cases[tag] = (lambda a=a: prep.rf_operands(*a),
                      lambda a=a: prep.rf_operands_plain(*a),
                      cs.KERNEL_NAMES['K6'])
    return cases


def flat(torch, out):
    """A wrapper's outputs (tensors, nested in tuples) as one flat
    tuple."""
    if torch.is_tensor(out):
        return (out,)
    return tuple(x for o in out for x in flat(torch, o))


def compare(torch, got, want):
    """(bitwise, max |error| of each float output where both are
    finite, flips of boolean outputs: K2's found, K1's valid) of a
    kernel's outputs."""
    errs, flips = [], 0
    got, want = flat(torch, got), flat(torch, want)
    for a, b in zip(got, want):
        if a.dtype == torch.bool:
            flips += int((a != b).sum())
            continue
        both = torch.isfinite(a) & torch.isfinite(b)
        errs.append(float((a - b)[both].abs().max()) if bool(both.any())
                    else 0.0)
    return all(torch.equal(a, b) for a, b in zip(got, want)), errs, flips


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--relax', action='append', default=[],
                    choices=sorted(RELAXED))
    ap.add_argument('--tree', help='time the port of this tree instead')
    ap.add_argument('--rounds', type=int, default=5)
    ap.add_argument('--out', default='results')
    opts = ap.parse_args()
    if opts.tree:
        if opts.relax:
            raise SystemExit('--relax builds this tree only')
        sys.path.insert(0, os.path.abspath(opts.tree))
        # that tree's chip_smoke.py: its kernel names and inputs are the
        # ones of that tree's kernels
        global cs
        del sys.modules['chip_smoke']
        import chip_smoke as cs

    import torch
    if not torch.cuda.is_available():
        raise SystemExit('kernel_variants.py needs a CUDA device')
    from bayhunter_tpu_torch.ops import _ext
    dev = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = {'shipped': (_ext.load(), ptxas_lines(_ext.library_path()))}
    for name in opts.relax:
        flags = [f for f in _ext.NVCC_FLAGS if f != '--fmad=false'] \
            + RELAXED[name]
        libs[name] = (_ext._build_and_load(flags),
                      ptxas_lines(_ext.library_path(flags)))
    cases = inputs(torch, dev)
    twins = {k: twin() for k, (_, twin, _) in cases.items()}
    times = {name: {k: [] for k in cases} for name in libs}
    device = {name: {k: [] for k, c in cases.items() if c[2]}
              for name in libs}
    for r in range(opts.rounds):
        for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
            _ext._Build.lib = libs[name][0]
            for k, (fn, _, kernel) in cases.items():
                times[name][k].append(cs.timed(fn, cs.KERNEL_REPS))
                if kernel:
                    device[name][k].append(cs.profiled(fn, cs.KERNEL_REPS,
                                                       kernel))
    record = {'card': smi, 'builds': {}}
    for name, (lib, ptx) in libs.items():
        _ext._Build.lib = lib
        checks = {k: compare(torch, fn(), twins[k])
                  for k, (fn, _, _) in cases.items()}
        rec = {'build': name, 'ptxas': ptx, 'kernels': {
            k: dict(ms_median=float(np.median(times[name][k])),
                    ms=times[name][k], bitwise=checks[k][0],
                    max_abs_err=checks[k][1], found_flips=checks[k][2])
            for k in cases}}
        for k, ms in device[name].items():
            rec['kernels'][k].update(device_ms_median=float(np.median(ms)),
                                     device_ms=ms)
        record['builds'][name] = rec
        print(json.dumps(rec), flush=True)
    _ext._Build.lib = libs['shipped'][0]
    if opts.relax:
        os.makedirs(opts.out, exist_ok=True)
        with open(os.path.join(opts.out, 'kernel_variants.json'),
                  'w') as f:
            json.dump(record, f, indent=1)


if __name__ == '__main__':
    main()
