"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``bayhunter_tpu_torch/csrc`` with
nvcc (one process per source, started together): K1 model operands, K2
warm root walker (Rayleigh and Love), K3 RF response (uniform Q, P and
SV, each solver-options arm), K3r RF response (per-layer Q, P and SV,
each options arm), K4/K5 Rayleigh and Love secular values, K6 RF
operands (with and without the earth flattening). Checks each against
its plain PyTorch twin on the card at the main paths' shapes (10,240
chains, 21 layer slots; K1 with one and with two RF targets, also on
2,048 chains; K4/K5 on the first 64-candidate counting block of 21
periods of 10,240 grown models, and on one cold-init chunk of 2,048
initial single-layer models as ``init_states_host`` draws them at the
cold search's three grids, sign 0, counting block and refinement; K6 for
P and SV on 10,240 models and on that chunk; K3 at the warm 99 and the
cold 257 frequencies; K3r at 99 frequencies on path A's models and Q),
timing both with CUDA events (K1, K6, and K4/K5 on the cold chunk: the
kernel's device time by torch.profiler, after the main paths, and the
wrapper's back-to-back calls by CUDA events beside it; K4/K5 at 10,240
chains by both) beside the kernel's bound (the larger of its bytes over
3.35 TB/s and its operations over 67 TFLOP/s, the H100's float32 peak,
counted from this run's inputs), and prints K1's, K2's, K3's, K4/K5's
and K6's launch geometry (K4/K5 with the occupancy calculator's resident
warps per SM) and K2's and K3's executed-per-useful lane work. Runs the
ragged shapes of ``tests/test_torch_cuda.py`` (C = 1, 37, 10,237 chains;
K2 at R = 1, 21, 60 periods, K3/K3r at F = 1, 99, 257 lanes; K4/K5 on C
= 1, 7, 2,051 chains of 2, 21, 64 slots) bit for bit against the twins.
Checks the tutorial truth model against the committed golden data
(``tests/fixtures/st3_*.dat``): the cold Rayleigh and Love solves (K4,
K5), the cold P and S receiver functions (K6, K3 at 257 frequencies),
the warm walker for both wave types (K2), the warm P and S receiver
functions (K3), and ``rf.synrf`` with uniform Q given as arrays (K6,
K3r) for both waves.

New arms, (e): K1's spherical arm (``prep_sph_kernel``: the flat set,
the spherical Rayleigh set and the spherical Love density plane beside
the P- and S-RF sets) at 10,240 grown models and on the 2,048-chain
width, K2's group arm (2P lanes, 12 bisections; Rayleigh and Love at 21
and 60 periods, 42 and 120 lanes, in the vs, z and dim settings) and K2
on the spherical set (Rayleigh, and Love with its density plane), each
bit for bit against its twin into NaN-filled memory, timed by CUDA
events and by the profiler beside the flat arms (``device_ms``).  Then
(f), the public forward without a device argument: ``SurfDisp`` and
``SynRF`` on the tutorial truth model against the six goldens, and
``surfdisp_batch`` of 10,240 grown models for Rayleigh group velocity,
spherical Rayleigh phase velocity and mode 2, in models/s.

Then it drives the paths through the port's entry points, each with
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
    two RF operand sets, K2, K3 twice per model step);
  * (g) ``tutorial_six`` — the six target kinds (Rayleigh and Love phase
    and group velocity, P- and S-RF): cold init (K4, K5, K6, K3), early
    cycles, ``SIX_LATE_CYCLES`` timed late cycles (K1 with two RF sets,
    K2 for Rayleigh and Love phase and group lanes, K3 for P and SV),
    then profiled as ``tutorial`` is; and ``tutorial_six_sph``, its
    dispersion targets on a spherical earth (K1's spherical kernel, K2
    on the spherical set, Love with its density plane).

Then it drives the inversion as users run it,
``MCMC_Optimizer.mp_inversion``, each run with the launch counts set to
0 before and read after (K1, K2, K3, K4, K6; K1's mantle arm in (c)):

  * (a) K1's mantle arm (mantle (4.1, 1.8) on the grown models, whose
    vs straddles 4.1) bit for bit against its twin at 10,240 chains
    and on the 2,048-chain cold chunk, into NaN-filled memory, timed by
    the profiler beside K1's no-mantle arm;
  * (b) the tutorial configuration (``tutorial/config.ini`` with
    ``tutorial/tutorialhunt.py``'s updates: vp/vs inverted, the RF corr
    fixed at 0.98, the degrees-of-freedom-corrected Gaussian RF law) on
    the fixtures with the port's ``SynthObs`` noise, 10,240 chains,
    2,048 + 1,024 iterations, ``maxmodels`` 64: the ``.npy`` contract
    of every chain and phase; then at 256 chains, 512 + 256 iterations,
    a run that checkpoints mid burn-in, stops, and resumes in a new
    optimizer, bit for bit equal to an uninterrupted run;
  * (c) the reference defaults (``defaults.ini``: the exponential RF
    law, an inverted vp/vs) with the mantle prior (4.1, 1.8) and
    positive SWD data errors (the scaled-error law), 10,240 chains,
    512 + 512 iterations, the same contract checks;
  * (d) the tutorial as its users run it, 21 chains, ``maxmodels``
    50,000, at the schedule S of ``docs/posterior_S/`` (4,096 + 2,048
    iterations, ``TUTORIAL_SCHEDULE``; the tutorial's 32,768 + 16,384
    runs in ``tools/tutorial_recovery.py``), checked against the range
    of the 64 committed port seeds at S (``RECOVERY_S``) and logged
    beside its seed's committed line.

Then (h), the receiver-function forms and custom targets: K6's
unflattened arm (``rf_prep_kernel<false>``, P and SV, 10,240 grown
models and the 2,048-chain cold chunk), K3's and K3r's options arms
(``rf.SUPPRESS_MULTIPLES``, ``rf.WITHOUT_ANELASTICITY`` and both; P and
SV at 10,240 chains) and K1's layer planes for a custom target (flat
and spherical kernel, 10,240 and 2,048 chains), each bit for bit against
its twin into NaN-filled memory and timed beside its default arm; then,
with the counts set to 0, ``synrf_batch(flattening=False)`` and
``synrf(options=k)`` of the tutorial model against the float64 forward
on the CPU, ``rf_pd.invert_rf`` in float32 (four perturbed tutorial
models, the rms trace falling by ``RF_PD_FACTOR``, no kernel launched),
and ``MCMC_Optimizer`` on Rayleigh phase + P-RF + a custom target with
the port's template plugin at ``CUSTOM_CHAINS`` chains (K1 with its
layer planes, K2, K3 in the steps; finite logL of the chains that
accepted).

Then (i), the ensemble extensions, each with the counts set to 0 before
and read after: (i-1) the tutorial under parallel tempering
(``bench_config.build_tempered``: 2,560 posterior chains x 4 rungs =
10,240 on the card, tmax 1,000, a sweep after every cycle, the burn-in
ladder adaptation, ``TEMPERED_ITERS`` 512 + 512 iterations) through
``MCMC_Optimizer``:
the ``.npy`` contract of the 2,560 cold chains alone, the per-gap swap
rates, the swap proposals against those the schedule places, the
adapted ladder, the cold rung's logL above the hottest's, a run stopped
mid burn-in and resumed bit for bit (K1, K2, K3, K4, K6); (i-2)
``parallel.TomoInversion`` of ``bench_config.build_tomo`` (1,000 cells x
100 chains = 100,000 chains, 3,200 + 1,600 iterations) held to
``tests/test_tomo.py``'s bound at 5 km, its cold init timed, peak
device memory, K1's and K2's device time at 100,000 chains beside
10,240 (K4, K1, K2).  The ragged phase also holds K1 and K2 at C =
100,000 and 100,003.

Then (j), the post-processing and the front ends, each with the counts
set to 0 before and read after: (j-1) the port's ``PlotFromStorage`` on
(d)'s files on the card (``save_final_distribution(maxmodels=100000,
dev=0.05)`` as ``tutorial/tutorialhunt.py`` calls it, its outliers
those of ``recovery_summary``, ``convergence_report``,
``ModelMatrix.get_singlemodels`` of the pooled models, the medians at
10, 30 and 60 km), and ``plotting.datafits`` of each kept chain's best
and latest model on the card (K4, K6, K3) held to the same fits on the
CPU at (f)'s bounds; (j-2) ``SingleChain`` on the tutorial, 512 + 512
iterations, twice from one seed: the reference layout, equal arrays,
K4, K6, K3 at its cold init and K1, K2, K3 in its steps.  Neither
imports matplotlib nor zmq.

Then (k), the chain split (``parallel/mesh.py``) over two workers,
each a spawned process with its own evaluator: on two GPUs where the
machine has them, else both on ``cuda:0``.  (k-1) ``tomo_1000x100``
split (100,000 chains, (i-2)'s seeds and iterations): every field of the
final states and every array of the summary bit for bit equal to
(i-2)'s one-card run, its wall time and late proposals/s beside
(i-2)'s, each worker's peak device memory and launches (K4, K1, K2);
(k-2) (b)'s configuration at 10,240 chains, the resort off, its segment
pinned, ``SPLIT_ITERS``: ``mp_inversion`` split writes the ``.npy``
files (the parent, which holds every snapshot), and every array of every
file equals the snapshots of the same run on one card without files,
bit for bit, as do the final states; then the tempered tutorial
(``build_tempered``'s 2,560 x 4 chains, resort off, sweeps and the
burn-in ladder adaptation) in memory, split and on one card: equal
snapshots, final states (swap counters among them) and ladder (K1, K2,
K3, K4, K6 in the workers); (k-3) a worker's cost of drawing and of
the batch-shape-dependent products at the one-card width: (k-2)'s
sampler on half the chains, late cycles timed with the block placed in
the whole batch and as a batch of its own.  Every earlier phase runs on
one card (``device=``).  The workers' launch counts join the kernels'
line under ``split_tomo`` and ``split_optimizer``, the one-card
references' under ``split_references``; every worker is joined before
the last two lines.

Then (l), the JAX package's statistical gates of the sampler
(``bayhunter_tpu_torch/gates.py``, the JAX tests' recipes and bands)
with the kernels and the tutorial scripts, each step with the counts
set to 0 before and read after and its wall seconds: (l-1) the
dimension-reject pin (grown ensemble, two rounds of birth then death;
birth <= 10 %, death 12-33 %, combined 5-17 % at 128 chains; measured
at 10,240) and (l-2) the converged band (the captured snapshot tiled to
252 chains; 6-22 %) (K1, K2, K3, K4, K6); (l-3) the warm walker (K2)
against the port's float64 cold solve on the CPU (median < 2e-6, p99 <
2e-5, outliers <= 1 %); (l-4) the prior-only layer histogram at the
tutorial's priors, 10,240 chains (K1; every bin within 0.035 of
uniform); (l-5) ``tutorial/create_testdata_torch.py`` (K4, K5, K6, K3)
against the golden fixtures; (l-6) ``tutorial/tutorialhunt_torch.py``
at 21 chains, 512 + 512 iterations, without figures: the ``.npy``
contract and the final posterior arrays.

Then (m), the JAX package's per-chain ring path (``build_evaluator(...,
use_batch_swd=False)``, the path of every float64 run) and the float64
instances of K3, K4, K5 and K6: (m-1) each against its twin run in
float64 on the card, bit for bit, at 10,240 grown chains (K4/K5 on the
ring's first trip at half-width 16, (C, 21, 33), around the chains'
float64 cold roots; K6 on their layer planes; K3 at all 257 lanes),
records ``K4_f64``, ``K5_f64``, ``K6_f64``, ``K3_f64`` bound by float64
operations over 34 TFLOP/s; (m-2) ``tutorial`` on the ring path at
10,240 chains in float32 and in float64: cold init, the early cycles
and 32 timed late iterations, proposals/s, the forward rejects (the
dimension moves' under ``RING_DIM_REJECT_PCT``), the launches (K4, K6,
K3 of the run's type; no K1, no K2) and the dimension steps' ring
trips; (m-3) ``MCMC_Optimizer(dtype=torch.float64)`` at 1,024 chains,
256 + 256, with the ``.npy`` contract (float32 files) and no float32
kernel launched.

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

import itertools
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD = 'cuda:0'       # the device of every one-device run
C_MAIN = 10240
NL = 21
ITERS = 2000          # bench.py's iter_burnin = iter_main
LATE_CYCLES = 32      # timed late cycles of each main path
PATH_A_CALLS = 5      # synrf_batch calls of path A per wave type
KERNEL_REPS = 20
STEP_REPS = 20        # host-clock steps per move in the profile phase
PROFILE_CYCLES = 4    # late cycles under torch.profiler
COLD_CHUNK = 2048      # chains per cold-init chunk (evaluator.COLD_CHUNK)
# device kernel names, as the profiler lists them
KERNEL_NAMES = {'K1': '::prep_kernel<', 'K2': 'walk_kernel',
                'K3': 'resp_kernel<float', 'K4': 'secular_kernel<float, 2>',
                'K5': 'secular_kernel<float, 1>',
                'K6': 'rf_prep_kernel<float',
                'K1_sph': '::prep_sph_kernel<',
                'K6_unflat': 'rf_prep_kernel<float, false>'}
SIX_LATE_CYCLES = 16  # timed late cycles of each six-target path
PUBLIC_CALLS = 3      # surfdisp_batch calls per case of phase (f)
# (e): K1's dispersion sets — the flat set, the spherical Rayleigh set
# and the spherical Love density plane
SPH_SPECS = ((2, 0), (2, 1), (1, 1))
GROUP_PERIODS = (21, 60)   # (e): K2's group arm at 42 and 120 lanes
WARM_KERNELS = ('K1', 'K2', 'K3')     # the kernels of a late step
# kernel entries whose ptxas lines tools/kernel_variants.py reports
PTXAS_KERNELS = ('prep_kernel', 'walk_kernel', 'resp_kernel',
                 'secular_kernel')

# the optimizer runs: (b) and (c) at C_MAIN chains, (d) the tutorial's
# own size; seeds fixed
OPT_ITERS_B = (2048, 1024)    # burn-in, main
OPT_SEGMENT_B = 256           # pinned segment of (b)'s contract run
# (b)'s stop-and-resume pair and its uninterrupted reference: chains,
# burn-in and main iterations, snapshots a phase (thin 16 and 8: whole
# cycles), the pinned segment; the stopped run stops at its 3rd
# checkpoint, mid burn-in
OPT_RESUME_CHAINS = 256
OPT_RESUME_ITERS = (512, 256)
OPT_RESUME_MAXMODELS = 32
OPT_RESUME_SEGMENT = 64
OPT_STOP_B = 3
OPT_ITERS_C = (512, 512)
OPT_SEED = 20261017
TUTORIAL_SEED = 1
# (d)'s segment, pinned: the segment sets where the chains are resorted
# and where the move schedule's uniforms are drawn, so a calibrated one
# (about 1,000 iterations on the card) would make the sample path, and
# the recovery check, depend on the host's speed
TUTORIAL_SEGMENT = 1024
# (d)'s schedule: S, the shortened schedule of docs/posterior_S/ (the
# tutorial's 32,768 + 16,384 took 168-352 s of this script's time)
TUTORIAL_SCHEDULE = (4096, 2048)
MANTLE = (4.1, 1.8)
# (m): the ring path.  K4/K5's float64 check grid: the first trip of the
# vs moves' ring (half-width 16); the late iterations timed at 10,240
# chains; the bound on the dimension moves' forward rejects (the JAX
# package's CPU runs, which take this path, recorded none); the float64
# optimizer run's chains and iterations
RING_CHECK_HALFWIDTH = 16
RING_LATE_ITERS = 32
RING_DIM_REJECT_PCT = 1.0
F64_CHAINS = 1024
F64_ITERS = (256, 256)
# (h): the RF solver options (rf.SUPPRESS_MULTIPLES = 1,
# rf.WITHOUT_ANELASTICITY = 2), the custom-target run's chains and
# iterations, and the bound on rf_pd.invert_rf's rms[-1] / rms[0] in
# float32 (the four models fell by 3.4e-5 to 1.8e-4 on the CPU in
# float32, where the float32 RF's rounding sets the floor)
OPTIONS = {1: 'SUPPRESS_MULTIPLES', 2: 'WITHOUT_ANELASTICITY',
           3: 'SUPPRESS_MULTIPLES | WITHOUT_ANELASTICITY'}
CUSTOM_CHAINS = 1024
CUSTOM_ITERS = (256, 256)
RF_PD_FACTOR = 1e-3
SNAP_NAMES = ('models', 'likes', 'misfits', 'noise', 'vpvs')
# (i): the ensemble extensions.  The tempered tutorial (bench_config.
# build_tempered, 2,560 posterior chains x 4 rungs) at a depth of
# TEMPERED_ITERS, its snapshots thinned to a cycle or more
# (TEMPERED_MAXMODELS: thin 8, so that the sweeps run), its pinned
# segment (bit-for-bit resume) and the checkpoint its second run stops
# at (mid burn-in); the tomography map
# (bench_config.build_tomo, 1,000 cells x 100 chains, its iterations in
# bench_config.TOMO_INITPARAMS): its segment, and tests/test_tomo.py's
# bound at 5 km (:43-44) with the share of cells that must hold it
# against their own family's truth
TEMPERED_ITERS = (512, 512)
TEMPERED_MAXMODELS = 64
TEMPERED_SEGMENT = 128
TEMPERED_STOP = 2
TOMO_SEGMENT = 200
# (k): the split on the card, two workers (on two GPUs where there are)
SPLIT_ITERS = (256, 256)      # (k-2): (b)'s configuration, burn-in, main
SPLIT_MAXMODELS = 32          # thin 8: whole cycles, as in (b)
SPLIT_SEGMENT = 128           # its pinned segment
SPLIT_TEMPERED_ITERS = (192, 128)   # the tempered split, in memory
SPLIT_TEMPERED_MAXMODELS = 16       # thin 12 and 8: sweeps run
SPLIT_TEMPERED_SEGMENT = 64
SPLIT_COST_ROUNDS = 8         # (k-3): timed rounds, alternating
SPLIT_COST_CYCLES = 8         # late cycles a round
# (l): the dimension-reject pin also measured at 10,240 chains; the
# prior-only histogram at 10,240 chains over 20 segments (15 dropped):
# a bin's standard error with each chain's samples taken as one draw,
# sqrt(0.05 * 0.95 / 10,240) = 0.0022, under a third of the 0.035
# tolerance; the tutorial script at 21 chains, 512 + 512 iterations
GATE_WIDE = 10240
PRIOR_GATE_CHAINS = 10240
PRIOR_GATE_SEGMENTS = 20
HUNT_CHAINS = 21
HUNT_ITERS = (512, 512)
HUNT_SEED = 20261019
TOMO_DEPTH = 5.0
TOMO_BOUND = 0.45
TOMO_CELL_SHARE = 0.9
# (i): the widths of K1 and K2's ragged checks and profiles beyond the
# main path's: the tomography batch and a ragged one
TOMO_WIDTHS = (100000, 100003)
# (d)'s recovery bands at S: the range of the 64 port seeds at S in
# docs/posterior_S/port_S.json (tools/tutorial_recovery.py on the card,
# PERF.md section 4), a little wider: the posterior's layer-count mode
# (nuclei, halfspace included; 5-7 at S), P(5) + P(6) of the pooled
# better half (0.156-1.0: a 21-chain run keeps 1-5 chains at S), the
# noise medians (injected: sigma_RF 0.005, sigma_SWD the std of the
# drawn SWD noise, 0.0111; 0.00509-0.01067 and 0.0107-0.0422 at S) and
# vp/vs (1.73; 1.7237-1.7472 at S)
RECOVERY_S = {'nlay_mode': (5, 7), 'p56': (0.15, 1.0),
              'sigma_rf_median': (0.0050, 0.0110),
              'sigma_swd_median': (0.0105, 0.0430),
              'vpvs_median': (1.72, 1.75)}
# the summary fields of (d) that a seed's committed line holds
RECOVERY_FIELDS = ('nlay_hist', 'p56', 'sigma_rf_median',
                   'sigma_swd_median', 'vpvs_median', 'accept_pct',
                   'fwd_reject_pct', 'chains_kept')

# (f): the public forward's bounds against the golden data, per target
# (1e-4 phase, 5e-4 Rayleigh group, 1e-3 Love group,
# tests/test_swd.py:35-36; P-RF 2e-4, tests/test_targets.py:37; S-RF
# 1e-4); (j) holds the data fits on the card to the CPU's with them
PUBLIC_TOLS = {'rdispph': 1e-4, 'rdispgr': 5e-4, 'ldispph': 1e-4,
               'ldispgr': 1e-3, 'prf': 2e-4, 'srf': 1e-4}
# (j): the post-processing of (d)'s files as tutorial/tutorialhunt.py
# calls it, the depths whose posterior medians are logged, and
# SingleChain on the tutorial (its iterations, maxmodels and seed)
POST_MAXMODELS = 100000
POST_DEV = 0.05
POST_DEPTHS = (10.0, 30.0, 60.0)
SINGLE_ITERS = (512, 512)
SINGLE_MAXMODELS = 256
SINGLE_SEED = 20261018

# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM bytes/s,
# and float32 and float64 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
PEAK_FLOPS_F64 = 34e12
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
    resp_layer_suppress=150,  # resp.cu SUPPRESS arm: two phase terms,
    #                           columns and one 2x2 product
    resp_fixed=500,       # resp.cu: Q factors, surface layer, closure
    resp_q_phase=18,      # resp.cu phase_q over phase: the complex
    #                       velocity (6), its square (6), its inverse (6)
    resp_q_slot=3,        # resp.cu: the Q-contrast test of one slot
    rf_interface=420,     # cplx.cuh interface_coeffs + skip-depth test
    rf_flatten_slot=15,   # prep.cu flatten: two logs, a quotient
    rf_t0_slot=10,        # prep.cu rf_rows: t0 term of one slot
    rf_fixed=150,         # displacement and free-surface matrices
    model_slot=35,        # voronoi, validity and SWD rows of one slot
    mantle_slot=4,        # prep.cu mantle arm: compare, min, select, mul
    model_fixed=150,      # gtsolh's five Newton steps
    sph_slot=30,          # prep.cu sphere_slot: three logs, two exps,
    #                       three divisions, and the scan of one slot
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


def profiled(fn, reps, name, required=True):
    """Median device time (ms) of the kernel named ``name`` (a substring
    of the profiler's kernel name) over ``reps`` calls of ``fn`` under
    torch.profiler, after one warm-up: the kernel alone, without the
    wrapper's host time that CUDA events around back-to-back calls
    hold.  None, unless ``required``, when no session recorded it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the profiler may drop a launch's record, or now and then all of a
    # session's, several sessions in a row (PERF.md), never add one: a
    # session that recorded none is run again, at most five in all
    for _ in range(5):
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
    if not us and not required:
        return None
    if not 0 < len(us) <= reps:
        raise AssertionError('the profiler saw %d launches of %s in %d '
                             'calls' % (len(us), name, reps))
    return 1e-3 * float(np.median(us))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def entry(counter, name, source, replaces, err, ms, plain_ms, moved, ops,
          wrapper_ms=None, peak=PEAK_FLOPS):
    """One kernel's record of the JSON line: ``moved`` bytes (each input
    read once, each output written once) and ``ops`` operations that this
    run's inputs need, at ``peak`` operations/s (float32's, or
    ``PEAK_FLOPS_F64`` for a float64 instance), give the bound;
    ``counter`` names its
    launch count in :func:`launch_counts`.  ``ms`` is the kernel's time
    by CUDA events over back-to-back wrapper calls; for K1, K6 and K4/K5
    on the cold chunk, whose wrappers take about as long on the host as
    the kernel on the card, it is None until :func:`profile_kernels`
    fills in the profiler's device time, and the event time is
    ``wrapper_ms``."""
    t_bytes = 1e3 * moved / PEAK_BYTES
    t_ops = 1e3 * ops / peak
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
    calls.update(WALK_CALLS)
    calls.update(RF_FORM_CALLS)
    for k in kernels:
        name = KERNEL_NAMES.get(k['counter'], KERNEL_NAMES[k['counter'][:2]])
        if k['ms'] is None:
            k['ms'] = profiled(calls[k['counter']], KERNEL_REPS, name, False)
            if k['ms'] is None:
                # no session recorded a launch: the wrapper's time by
                # CUDA events stands in, marked as such
                log('%s: the profiler recorded no launch in five '
                    'sessions; its ms is the wrapper\'s by CUDA events'
                    % k['name'])
                k['ms'], k['ms_by'] = k['wrapper_ms'], 'events'
            k['bound_share'] = k['bound_ms'] / k['ms']
        elif k['counter'] in ('K4', 'K5') or k['counter'] in WALK_CALLS:
            k['device_ms'] = profiled(calls[k['counter']], KERNEL_REPS,
                                      name, False)
    log('K4/K5 on the cold chunk\'s sign-0 and refine grids, device ms '
        '(profiler): ' + json.dumps({
            key: profiled(call, KERNEL_REPS, KERNEL_NAMES[key[:2]], False)
            for key, call in calls.items()
            if key[2:].startswith('_cold_')}))


def grown_models(C, nl, seed=3):
    """Seeded 5-8 layer models around the tutorial truth,
    ``gates.grown_models``: the draws of tests/test_dim_reject_pin.py
    ``_grown_states``, padded as the port's states are."""
    from bayhunter_tpu_torch import gates
    return gates.grown_models(C, nl, seed)


def secular_ops(top, evaluations, iwave):
    """Operations of the secular function: ``evaluations`` per chain (a
    number, or (C, R) per lane), each running the chain's layers
    top..0."""
    layer, fixed = ((OPS['haskell_layer'], OPS['haskell_fixed'])
                    if iwave == 1 else
                    (OPS['dunkin_layer'], OPS['dunkin_fixed']))
    per_eval = fixed + (top.double()[:, None] + 1.0) * layer
    return float((evaluations * per_eval).sum())


def warm_starts(torch, layers, periods, iwave, igr=0):
    """K2's inputs of the kernel phase, (c_prev, slopes) each (C, R), R
    the periods' lanes (2 per period for group velocity, ``igr``): the
    cold roots and bracket slopes of the (C, NL) ``layers`` (K4 or K5,
    2,048 chains at a time), the roots moved off the DDC grid by a
    seeded offset."""
    from bayhunter_tpu_torch.ops import swd

    roots, slopes = [], []
    for i in range(0, layers[0].shape[0], 2048):
        _, _, r_, s_ = swd.surfdisp_roots_cold(
            *(x[i:i + 2048] for x in layers), periods, iwave, igr=igr)
        roots.append(r_)
        slopes.append(s_)
    roots, slopes = torch.cat(roots), torch.cat(slopes)
    gen = torch.Generator(device=roots.device)
    gen.manual_seed(11)
    return roots + 0.0013 + 0.04 * (torch.rand(
        roots.shape, generator=gen, device=roots.device) - 0.5), slopes


WALK_CALLS = {}   # K2 record counter -> its vs-move call (profiled)


def check_walker(torch, counter, name, iwave, wargs, slopes, rho=None,
                 group=False, record=True):
    """K2 for one wave type against its twin, for each move class:
    (record, max error), or with ``record`` False None.  ``rho``: the
    density plane read in place of plane 3; ``group``: a group target's
    lanes, 12 bisections in every move class.  The bound counts the
    secular evaluations each lane makes (the twin counts them)."""
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
                  nbisect=swd.GROUP_NBISECT if group else st['nbisect'],
                  newton_iters=st['newton_iters'],
                  newton_maxshift=swd.NEWTON_MAXSHIFT, slope_prev=sl,
                  iwave=iwave, rho=rho)
        cuda_cases()._poison(props.device)
        kc, kf, ks = walk.warm_roots_walk(*wargs, group=group, **kw)
        pc, pf, ps = walk.warm_roots_walk_plain(*wargs, **kw)
        if move == 'vs' and record:
            WALK_CALLS[counter] = (lambda kw=kw: walk.warm_roots_walk(
                *wargs, group=group, **kw))
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
        ms += timed(lambda: walk.warm_roots_walk(*wargs, group=group, **kw),
                    KERNEL_REPS)
        if not record:
            continue
        plain_ms += timed(lambda: walk.warm_roots_walk_plain(*wargs, **kw),
                          2)
        moved += nbytes(props, omegas, c_prev, cm, bx, top, sl, rho, kc, kf,
                        ks)
        ops += secular_ops(top.clamp(max=NL - 2), evals.double(), iwave)
        ops += OPS['walk_eval'] * float(evals.double().sum())
    geo = walk.geometry(C_MAIN, R, NL, iwave)
    log('%s: geometry %s, %d of a block\'s %d threads serve lanes in its '
        'first round; kernel %.4f ms by CUDA events (vs, z, dim average)'
        % (name, geo, min(geo.tile * R, geo.threads), geo.threads, ms / 3))
    if not record:
        return None
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
        1, swd.KBLOCK, swd.NBLOCKS)
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
    mantle = ev.priors._replace(mantle=MANTLE)
    calls = {
        'K1': lambda: prep.model_operands(*nuclei, ev.priors,
                                          ev.rf_specs[:1]),
        'K1_mantle': lambda: prep.model_operands(*nuclei, mantle,
                                                 ev.rf_specs[:1]),
        'K1_2rf': lambda: prep.model_operands(*nuclei, ev.priors,
                                              ev.rf_specs),
        'K1_sph': lambda: prep.model_operands(*nuclei, ev.priors,
                                              ev.rf_specs, SPH_SPECS),
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

    # (a) K1's mantle arm: the grown models' vs straddles the
    # threshold 4.1, at 10,240 chains and the cold chunk's width, into
    # NaN-filled memory
    mantle = ev.priors._replace(mantle=MANTLE)
    args = nuclei + (mantle, ev.rf_specs[:1])
    in_m = ((nuclei[0] >= MANTLE[0]) & (
        torch.arange(NL, device=dev)[:, None] < nuclei[2][None, :])
    ).any(dim=0)
    for C in (C_MAIN, COLD_CHUNK):
        part = tuple(x[..., :C].contiguous() for x in nuclei) + args[4:]
        cuda_cases()._poison(dev)
        mv, ksw_m, krf_m = prep.model_operands(*part)
        pv, psw, prf = prep.model_operands_plain(*part)
        if not torch.equal(mv, pv):
            raise AssertionError('K1 (mantle) validity differs from its '
                                 'twin on %d chains' % int((mv != pv).sum()))
        err = check_bitwise(
            torch, 'K1 model operands, mantle arm, %d chains (%d with a '
            'mantle slot)' % (C, int(in_m[:C].sum())), ksw_m + krf_m[0],
            psw + prf[0])
        if C == C_MAIN:
            err1, props_m = err, ksw_m[0].clone()
    plain = prep.model_operands_plain(*nuclei, ev.priors, ev.rf_specs[:1])
    if torch.equal(plain[1][0], props_m) or not int(in_m.sum()) > 0:
        raise AssertionError('the mantle arm changed no walker plane')
    mv, msw, mrf = prep.model_operands(*args)
    out.append(entry(
        'K1_mantle', 'K1 model operands, mantle arm', 'prep.cu',
        'pallas_prep.py:315', err1, None,
        timed(lambda: prep.model_operands_plain(*args), 3),
        nbytes(*nuclei, mv, *msw, *mrf[0]),
        C_MAIN * (OPS['model_fixed'] + NL * (
            OPS['model_slot'] + OPS['mantle_slot'] + OPS['rf_flatten_slot'])
            + OPS['rf_fixed'] + NL * OPS['rf_t0_slot']
            + (NL - 1) * OPS['rf_interface']),
        timed(calls['K1_mantle'], KERNEL_REPS)))

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
    out += check_new_arms(torch, dev, ev, nuclei, layers, props, cm, bx, top,
                          calls)
    return out


def check_new_arms(torch, dev, ev, nuclei, layers, props, cm, bx, top,
                   calls):
    """(e): K1's spherical arm and K2's group and spherical-Love arms
    against their twins bit for bit, into NaN-filled memory: K1 with the
    flat set, the spherical Rayleigh set and the spherical Love density
    plane (``SPH_SPECS``) and the P- and S-RF sets at 10,240 grown
    models and the cold chunk's width; K2's group arm, Rayleigh and
    Love, at 21 and 60 periods (42 and 120 lanes), in the vs, z and dim
    settings, on the flat set of the 10,240 grown models; K2 on the
    spherical set, Rayleigh on its planes and Love with the density
    plane.  Returns the records K1_sph, K2_group_R, K2_group_L and
    K2_sph_L (their device times by the profiler after the main paths,
    beside the flat arms')."""
    from bayhunter_tpu_torch.ops import prep, swd

    out = []
    specs = SPH_SPECS
    for C in (C_MAIN, COLD_CHUNK):
        part = tuple(x[..., :C].contiguous() for x in nuclei)
        cuda_cases()._poison(dev)
        kv, ksw, krf = prep.model_operands(*part, ev.priors, ev.rf_specs,
                                           specs)
        pv, psw, prf = prep.model_operands_plain(*part, ev.priors,
                                                 ev.rf_specs, specs)
        if not torch.equal(kv, pv):
            raise AssertionError('K1 (spherical) validity differs from '
                                 'its twin on %d chains'
                                 % int((kv != pv).sum()))
        kset = ksw[0][:4] + ksw[1][:4] + (ksw[2][4],) + sum(krf, ())
        pset = psw[0][:4] + psw[1][:4] + (psw[2][4],) + sum(prf, ())
        err = check_bitwise(
            torch, 'K1 model operands, spherical arm (flat set, spherical '
            'set, Love density plane, P- and S-RF), %d chains, geometry %s'
            % (C, prep.geometry(C, NL, len(ev.rf_specs), True, True)),
            kset, pset)
        if C == C_MAIN:
            err1, sph = err, ksw
    if torch.equal(sph[1][0], sph[0][0]) or torch.equal(
            sph[2][4], sph[1][0][3 * NL:]):
        raise AssertionError('the spherical arm changed no walker plane')
    args = nuclei + (ev.priors, ev.rf_specs, specs)
    kv, ksw, krf = prep.model_operands(*args)
    out.append(entry(
        'K1_sph', 'K1 model operands, spherical arm', 'prep.cu',
        'pallas_prep.py:315', err1, None,
        timed(lambda: prep.model_operands_plain(*args), 3),
        nbytes(*nuclei, kv, *ksw[0][:4], *ksw[1][:4], ksw[2][4],
               *sum(krf, ())),
        C_MAIN * (2 * OPS['model_fixed'] + NL * (
            OPS['model_slot'] + OPS['rf_flatten_slot'] + OPS['sph_slot'])
            + len(ev.rf_specs) * (OPS['rf_fixed'] + NL * OPS['rf_t0_slot']
                                  + (NL - 1) * OPS['rf_interface'])),
        timed(calls['K1_sph'], KERNEL_REPS)))

    # K2's group arm on the flat set: 2R lanes, 12 bisections
    for iwave, counter, tag in (
            (2, 'K2_group_R', 'K2 warm root walker (Rayleigh group)'),
            (1, 'K2_group_L', 'K2 warm root walker (Love group)')):
        for R in GROUP_PERIODS:
            periods = np.linspace(1.0, 41.0 if R == 21 else 60.0,
                                  R).astype(np.float32)
            c_prev, slopes = warm_starts(torch, layers, periods, iwave, 1)
            om = swd.lane_frequencies(periods, 1, dev)
            rec = check_walker(torch, counter, '%s, %d periods (%d lanes)'
                               % (tag, R, 2 * R), iwave,
                               (props, om, c_prev, cm, bx, top), slopes,
                               group=True, record=R == 21)
            if rec is not None:
                out.append(rec)

    # K2 on the spherical set: Rayleigh on its planes, Love on planes 0
    # and 2 with the Love density plane
    sprops, scm, sbx, stop, _ = ksw[1]
    rho_l = ksw[2][4]
    splanes = [sprops[k * NL:(k + 1) * NL] for k in range(4)]
    periods = ev.specs[0].periods
    for iwave, rho, counter, tag in (
            (2, None, 'K2_sph_R', 'K2 warm root walker (spherical '
             'Rayleigh)'),
            (1, rho_l, 'K2_sph_L', 'K2 warm root walker (spherical Love, '
             'its density plane)')):
        lay = tuple(x.T.contiguous() for x in splanes[:3] + [
            splanes[3] if rho is None else rho])
        c_prev, slopes = warm_starts(torch, lay, periods, iwave)
        rec = check_walker(torch, counter, tag, iwave,
                           (sprops, swd.lane_frequencies(periods, 0, dev),
                            c_prev, scm, sbx, stop), slopes, rho=rho,
                           record=iwave == 1)
        if rec is not None:
            out.append(rec)
    return out


RF_FORM_CALLS = {}   # (h) record counter -> its wrapper call (profiled)


def resp_ops(cut, depth, q, options):
    """Float32 operations of a K3 (``q`` False) or K3r launch of ``cut``
    lanes over chains of skip depth ``depth`` in arm ``options``."""
    layer = OPS['resp_layer_suppress'] if options & 1 else OPS['resp_layer']
    phase_q = 2 * OPS['resp_q_phase'] if q and not options & 2 else 0
    fixed = OPS['resp_fixed'] + (NL * OPS['resp_q_slot'] if q else 0)
    return cut * float((fixed + phase_q + depth * (layer + phase_q)).sum())


def check_rf_forms(torch, dev):
    """(h), the kernels: K6's unflattened arm (``rf_prep_kernel<false>``)
    for P and SV at 10,240 grown models and on the cold chunk; K3's and
    K3r's options arms 1-3 for P and SV at 10,240 chains (K6's operands
    of the grown models at the Gauss-cut lanes; K3r with path A's Q
    planes); and K1's layer planes for a custom target (the flat kernel
    with Rayleigh phase + P-RF, and the spherical kernel with spherical
    targets only, which then writes the flat set) at 10,240 and 2,048
    chains; each bit for bit against its twin into NaN-filled memory,
    timed by CUDA events beside its default arm (K6 and K1 also by the
    profiler, after the main paths).  Returns the records K6_unflat,
    K3_o1..3, K3r_o1..3 and K1_layers."""
    from bayhunter_tpu_torch.ops import prep, resp, rf

    ev, nuclei, planes, cold = phase_inputs(torch, dev)
    cplanes = tuple(x.T.contiguous() for x in cold)
    pspec = ev.specs[1]
    p = pspec.p_skm
    out = []
    k6, errs = {}, []
    for wave in (rf.P_WAVE, rf.SV_WAVE):
        for tag, pl in (('%d models' % C_MAIN, planes),
                        ('%d-chain cold chunk' % COLD_CHUNK, cplanes)):
            cuda_cases()._poison(dev)
            k = prep.rf_operands(*pl, p, wave, flattening=False)
            errs.append(check_bitwise(
                torch, 'K6 RF operands, unflattened arm (%s, %s)'
                % ('PS'[wave], tag), k,
                prep.rf_operands_plain(*pl, p, wave, flattening=False)))
            k6.setdefault(wave, k)
    off = rf.pack_offsets(NL)
    if not torch.equal(k6[rf.P_WAVE][1][off['vs']:off['vs'] + NL],
                       planes[2]):
        raise AssertionError('the unflattened pack does not carry the '
                             'raw vs')
    RF_FORM_CALLS['K6_unflat'] = lambda: prep.rf_operands(
        *planes, p, flattening=False)
    ms = {arm: timed(lambda: prep.rf_operands(*planes, p, flattening=arm),
                     KERNEL_REPS) for arm in (True, False)}
    log('K6 wrapper by CUDA events, 10,240 models: flattened %.4f ms, '
        'unflattened %.4f ms' % (ms[True], ms[False]))
    out.append(entry(
        'K6_unflat', 'K6 RF operands, unflattened arm', 'prep.cu',
        'pallas_prep.py:141', max(errs), None,
        timed(lambda: prep.rf_operands_plain(*planes, p, flattening=False),
              3),
        nbytes(*planes, *k6[rf.P_WAVE]),
        C_MAIN * (OPS['rf_fixed'] + NL * OPS['rf_t0_slot']
                  + (NL - 1) * OPS['rf_interface']), ms[False]))

    # K3 and K3r in each options arm, P and SV
    _, qp, qs = grown_layers(torch, dev)
    qp, qs = qp.T.contiguous(), qs.T.contiguous()
    cut = pspec.cut
    flat_ops = {wave: prep.rf_operands(*planes, p, wave)
                for wave in (rf.P_WAVE, rf.SV_WAVE)}
    for q, kernel, plain, name in (
            (False, resp.resp, resp.resp_plain, 'K3'),
            (True, resp.resp_q, resp.resp_q_plain, 'K3r')):
        times = {}
        for wave in (rf.P_WAVE, rf.SV_WAVE):
            coefs, pack = flat_ops[wave]
            lead = (coefs, pack) + ((qp, qs) if q else ())
            tail = (rf.FREF,) if q else ()
            depth = pack[off['depth']]
            if q:
                depth = rf.q_depth(depth, qp, qs)
            depth = depth.clamp(max=NL - 2).double()
            for k in (0,) + tuple(OPTIONS):
                args = lead + (cut, pspec.nsamp, pspec.fsamp, wave) + tail \
                    + (k,)
                times[wave, k] = timed(lambda: kernel(*args), KERNEL_REPS)
                if not k:
                    continue
                cuda_cases()._poison(dev)
                err = check_bitwise(
                    torch, '%s RF response, %s (%s, %d lanes)'
                    % (name, OPTIONS[k], 'PS'[wave], cut), kernel(*args),
                    plain(*args))
                if wave == rf.SV_WAVE:
                    continue
                out.append(entry(
                    '%s_o%d' % (name, k), '%s RF response, %s (%d lanes)'
                    % (name, OPTIONS[k], cut), 'resp.cu',
                    'pallas_rf.py:288', err, times[wave, k],
                    timed(lambda: plain(*args), 3),
                    nbytes(pack, *((qp, qs) if q else ()), *kernel(*args))
                    + 4 * 32 * C_MAIN * float((depth + 1).mean()),
                    resp_ops(cut, depth, q, k)))
        log('%s by CUDA events, 10,240 chains, %d lanes, ms by (wave, '
            'options): %s' % (name, cut, json.dumps(
                {'%s %d' % ('PS'[w], k): t for (w, k), t in times.items()})))

    # K1's layer planes for a custom target beside Rayleigh phase and
    # P-RF: the flat kernel, and the spherical kernel, which writes the
    # flat set only for them
    errs = []
    for swd_specs, tag in ((((2, 0),), 'flat kernel'),
                           (((2, 1),), 'spherical kernel')):
        for C in (C_MAIN, COLD_CHUNK):
            part = tuple(x[..., :C].contiguous() for x in nuclei) + (
                ev.priors, ev.rf_specs[:1], swd_specs)
            cuda_cases()._poison(dev)
            kv, ksw, krf, klay = prep.model_operands(*part, layers=True)
            pv, psw, prf, play = prep.model_operands_plain(*part,
                                                           layers=True)
            if not torch.equal(kv, pv):
                raise AssertionError('K1 (layer planes) validity differs')
            errs.append(check_bitwise(
                torch, 'K1 model operands with the layer planes (%s), %d '
                'chains' % (tag, C), klay + ksw[0][:4] + krf[0],
                play + psw[0][:4] + prf[0]))
    args = nuclei + (ev.priors, ev.rf_specs[:1], ((2, 0),))
    RF_FORM_CALLS['K1_layers'] = lambda: prep.model_operands(*args,
                                                             layers=True)
    kv, ksw, krf, _ = RF_FORM_CALLS['K1_layers']()
    out.append(entry(
        'K1_layers', 'K1 model operands with the layer planes', 'prep.cu',
        'pallas_prep.py:315', max(errs), None,
        timed(lambda: prep.model_operands_plain(*args, layers=True), 3),
        nbytes(*nuclei, kv, *ksw[0][:4], *krf[0]),
        C_MAIN * (OPS['model_fixed'] + NL * (OPS['model_slot']
                                             + OPS['rf_flatten_slot'])
                  + OPS['rf_fixed'] + NL * OPS['rf_t0_slot']
                  + (NL - 1) * OPS['rf_interface']),
        timed(RF_FORM_CALLS['K1_layers'], KERNEL_REPS)))
    return out


def rf_forms_path(torch, dev):
    """(h), the forward: ``synrf_batch(flattening=False)`` and
    ``synrf(options=k)``, k = 0..3, P and SV, with the default Q (K3)
    and with a per-layer Q model (K3r), of the tutorial model on the
    card against the plain functions in float64 on the CPU (within
    1e-4, the float32 response's rounding), then ``rf_pd.invert_rf`` in
    float32 on the card: four models perturbed from the tutorial model,
    the rms trace falling by ``RF_PD_FACTOR`` and no kernel launched.
    Returns the launch counts of the synrf calls."""
    from bayhunter_tpu_torch.ops import rf, rf_pd

    reset_counts()
    h, vp, vs, rho = (x[:, 0] for x in tutorial_layers(torch, dev))
    vs0 = float(vs[0])
    vpvs0 = float(vp[0]) / vs0
    poisson = (2.0 - vpvs0 ** 2) / (2.0 - 2.0 * vpvs0 ** 2)
    cpu = tuple(x.double().cpu() for x in (h, vp, vs, rho))
    # Qs rising through the model's four layers, the halfspace's below
    qs = torch.full((NL,), 400.0, device=dev)
    qs[:3] = torch.tensor([100.0, 225.0, 300.0])
    q_models = {'': (500.0, 225.0), ' per-layer Q': (2.25 * qs, qs)}
    errs = {}
    for wave in (rf.P_WAVE, rf.SV_WAVE):
        y = rf.synrf_batch(*(x[None] for x in (h, vp, vs, rho)), 500.0,
                           225.0, 6.4, 1.0, 512, 5.0, 5.0, vs0, poisson,
                           wave_type=wave, flattening=False)
        want = rf.synrf_batch(*(x[None] for x in cpu), 500.0, 225.0, 6.4,
                              1.0, 512, 5.0, 5.0, vs0, poisson,
                              wave_type=wave, flattening=False,
                              device='cpu')
        errs['synrf_batch unflattened ' + 'PS'[wave]] = float(
            (y.double().cpu() - want).abs().max())
        for (qtag, (qp, qs_)), k in itertools.product(q_models.items(),
                                                      range(4)):
            got = rf.synrf(h, vp, vs, rho, qp, qs_, 6.4, 1.0, 512, 5.0, 5.0,
                           vs0, poisson, wave_type=wave, options=k)
            want = rf.synrf(*cpu, *(q if isinstance(q, float)
                                    else q.double().cpu() for q in (qp, qs_)),
                            6.4, 1.0, 512, 5.0, 5.0, vs0, poisson,
                            wave_type=wave, options=k, device='cpu')
            errs['synrf options %d %s%s' % (k, 'PS'[wave], qtag)] = max(
                float((a.double().cpu() - b).abs().max())
                for a, b in zip(got, want))
    counts = launch_counts()
    log('(h) tutorial model on the card against float64 on the CPU, max '
        '|err| ' + json.dumps(errs) + ' (limit 1e-4 each), launches '
        + json.dumps(counts))
    if not all(e <= 1e-4 for e in errs.values()):
        raise AssertionError('(h): the RF forms miss the float64 forward')
    missing = [c for c in ('K6', 'K6_unflat', 'K3', 'K3_o1', 'K3_o2',
                           'K3_o3', 'K3r', 'K3r_o1', 'K3r_o2', 'K3r_o3')
               if counts[c] == 0]
    if missing:
        raise AssertionError('(h): kernels %s never launched' % missing)

    # rf_pd in float32 on the card: PyTorch operations, no kernel
    nl = 8
    hp = torch.zeros(nl, device=dev)
    hp[:3] = torch.tensor([5., 23., 8.])
    vsp = torch.full((nl,), 4.4, device=dev)
    vsp[:4] = torch.tensor([2.7, 3.6, 3.8, 4.4])
    vpp = vsp * 1.73
    obs = rf.synrf(hp, vpp, vsp, vpp * 0.32 + 0.77, 500.0, 225.0, 6.4, 1.0,
                   256, 5.0, 5.0, 2.7, poisson)[2][:128]
    rs = np.random.RandomState(3)
    dvs = rs.uniform(-0.08, 0.08, (4, nl)).astype(np.float32)
    dvs[:, 4:] = dvs[:, 3:4]
    vs_init = vsp[None] + torch.tensor(dvs, device=dev)
    before = launch_counts()
    t0 = time.perf_counter()
    vs_fit, rms = rf_pd.invert_rf(
        obs[None].expand(4, -1), hp[None].expand(4, -1), vs_init * 1.73,
        vs_init, 500.0, 225.0, 6.4, 1.0, 256, 5.0, 5.0, 2.7, poisson,
        nused=128, niter=6, rcond=1e-6, damping=0.01)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ratio = (rms[:, -1] / rms[:, 0]).cpu().numpy()
    log('(h) rf_pd.invert_rf, float32 on the card, 4 models: rms traces %s, '
        'rms[-1] / rms[0] %s (limit %g), max |vs - truth| %.3g km/s, %.2f s'
        % (json.dumps(rms.cpu().numpy().tolist()), ratio.tolist(),
           RF_PD_FACTOR, float((vs_fit - vsp).abs()[:, :4].max()), dt))
    if not (np.all(ratio < RF_PD_FACTOR)
            and bool(torch.isfinite(vs_fit).all())):
        raise AssertionError('(h): rf_pd did not converge')
    if launch_counts() != before:
        raise AssertionError('(h): rf_pd launched a kernel')
    return counts


def optimizer_custom(torch, tmp):
    """(h), the inversion: ``MCMC_Optimizer`` on Rayleigh phase + P-RF
    (the tutorial's targets and noise) + a custom target whose plugin is
    the port's template ``templates/myfwd.py``, at ``CUSTOM_CHAINS``
    chains for ``CUSTOM_ITERS`` iterations: K1 (with its layer planes),
    K2 and K3 in the steps, finite logL for the chains that accepted a
    proposal, the ``.npy`` contract.  Returns (stats, launches at init,
    launches)."""
    from bayhunter_tpu_torch import Targets, bench_config
    from bayhunter_tpu_torch.templates import myfwd
    joint, _ = bench_config.tutorial_targets()
    x = np.linspace(1.0, 10.0, 10)
    plugin = myfwd.MyForwardModel(x, 'mine')
    y = plugin.run_model([5., 23., 8., 0.], [4.7, 6.2, 6.6, 7.6],
                         [2.7, 3.6, 3.8, 4.4], [2.3, 2.8, 2.9, 3.2])[1]
    custom = Targets.SingleTarget(
        x, y + np.random.RandomState(5).normal(0.0, 0.01, x.size), 'mine')
    custom.noiseref = 'swd'
    custom.update_plugin(plugin)
    joint = Targets.JointTarget(joint.targets + [custom])
    priors, ip = bench_config.tutorial_params()
    ip.update(nchains=CUSTOM_CHAINS, iter_burnin=CUSTOM_ITERS[0],
              iter_main=CUSTOM_ITERS[1], maxmodels=16,
              savepath=os.path.join(tmp, 'h'))
    opt, wall, at_init, counts = run_optimizer(torch, joint, priors, ip,
                                               OPT_SEED)
    kinds = [spec.kind for spec in opt.eval_fn.specs]
    st = opt.final_states
    accepted = st.accepted.sum(dim=1) > 0
    stats = optimizer_stats(opt, wall)
    stats.update(kinds=kinds, snapshots=check_contract(opt),
                 chains_accepted=int(accepted.sum()), launches=counts)
    log('optimizer (h), Rayleigh phase + P-RF + custom target: '
        + json.dumps(stats))
    steps = {k: counts[k] - at_init[k]
             for k in ('K1', 'K1_layers', 'K2_rayleigh', 'K3')}
    if kinds != ['swd', 'rf', 'custom'] or not all(steps.values()):
        raise AssertionError('(h): targets %s, launches in the steps %s'
                             % (kinds, steps))
    logl = st.logL[accepted]
    if not (int(accepted.sum()) > 0 and bool(torch.isfinite(logl).all())
            and bool((logl > -1e14).all())):
        raise AssertionError('(h): logL not finite for the accepted '
                             'chains')
    return stats, at_init, counts


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


def cuda_cases():
    """The module of ``tests/test_torch_cuda.py`` (its cases and
    helpers)."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    import test_torch_cuda
    return test_torch_cuda


def check_ragged(torch, dev):
    """The redesigned K2, K3, K3r, K4 and K5 against their twins bit for
    bit at the ragged shapes of tests/test_torch_cuda.py: C = 1, 37,
    10,237 chains, R = 1, 21, 60 periods (K2, both waves, the three move
    classes), F = 1, 99, 257 lanes (K3 and K3r, P and SV); C = 1, 7,
    2,051 chains of 2, 21 and 64 layer slots, 21 or 60 periods of 1, 17
    or 64 candidates (K4 and K5, into NaN-filled memory); and K2 and K1
    (0, 1, 2 and 4 RF targets, into NaN-filled memory) at C = 100,000
    and 100,003 (``TOMO_WIDTHS``)."""
    cases = cuda_cases()
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
    # (i): K1 and K2 at the tomography's width and a ragged one above it
    t0 = time.perf_counter()
    n = 0
    for C in TOMO_WIDTHS:
        for R in (1, 21, 60):
            for iwave in (2, 1):
                cases.test_walker_ragged_shapes_bitwise(dev, C, R, iwave)
                n += 1
        for n_rf in (0, 1, 2, 4):
            cases.test_model_operands_ragged_shapes_bitwise(dev, C, n_rf)
            n += 1
    log('ragged shapes at %s chains: %d K1 and K2 cases bit for bit equal '
        'to their twins in %.1f s' % (TOMO_WIDTHS, n,
                                      time.perf_counter() - t0))


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


def launch_counts(raw=None):
    """The launch counts of every kernel wrapper: K1's spherical kernel
    beside all its launches, K2's split into disjoint arms (Rayleigh
    and Love phase lanes, group lanes of each wave, spherical Love phase
    lanes on the Love density plane), K3's and K3r's SV launches beside
    all their launches; of this process, or of ``raw`` (the wrappers'
    counters as ``ops.launch_counts`` gives them, a worker's report)."""
    from bayhunter_tpu_torch import ops
    raw = ops.launch_counts() if raw is None else raw
    m, f = raw['prep.model_operands'], raw['prep.rf_operands']
    w, r, q = raw['walk.warm_roots_walk'], raw['resp.resp'], raw[
        'resp.resp_q']
    group_r = w['group_launches'] - w['group_love_launches']
    return dict(K1=m['launches'], K1_sph=m['sph_launches'],
                K2_rayleigh=w['launches'] - w['love_launches'] - group_r,
                K2_love=(w['love_launches'] - w['group_love_launches']
                         - w['sph_love_launches']),
                K2_group_R=group_r, K2_group_L=w['group_love_launches'],
                K2_sph_L=w['sph_love_launches'], K3=r['launches'],
                K3_sv=r['sv_launches'], K3r=q['launches'],
                K3r_sv=q['sv_launches'],
                K4=raw['swd.secular4']['launches'],
                K5=raw['swd.secular1']['launches'],
                K6=f['launches'], K6_unflat=f['unflat_launches'],
                K1_layers=m['layer_launches'],
                K4_f64=raw['swd.secular4']['f64_launches'],
                K5_f64=raw['swd.secular1']['f64_launches'],
                K6_f64=f['f64_launches'], K3_f64=r['f64_launches'],
                K3_f64_sv=r['f64_sv_launches'], **option_counts(r, q))


def option_counts(r, q):
    """The options arms' launch counts of K3's (``r``) and K3r's (``q``)
    raw counters: ``K3_o<k>``/``K3r_o<k>`` of arm k (both waves), and
    ``K3_optP``/``K3_optSV`` (K3r likewise) the launches of arms 1-3 by
    wave, which the arm-0 records leave out."""
    out = {}
    for name, w in (('K3', r), ('K3r', q)):
        arms = w['option_launches']
        for k in OPTIONS:
            out['%s_o%d' % (name, k)] = sum(arms[v][k] for v in (0, 1))
        out[name + '_optP'] = sum(arms[0][1:])
        out[name + '_optSV'] = sum(arms[1][1:])
    return out


def worker_counts(reports, key='launches'):
    """The launch counts of a split run's workers, summed: ``key``
    'launches' at their close, 'launches_at_init' after the cold init."""
    per = [launch_counts(rep[key]) for rep in reports]
    return {k: sum(c[k] for c in per) for k in per[0]}


def reset_counts():
    from bayhunter_tpu_torch import ops
    ops.reset_launch_counts()


RATES = {}      # proposals/s of each main path of this run


def main_path(torch, dev, name, build, kernels, cycles=LATE_CYCLES):
    """One configuration through the port's entry points, ``cycles``
    late cycles timed, with the launch counts set to 0 before and read
    after; fails unless each of ``kernels`` launched and K3 launched
    once per RF target for each K1 launch of the steps.  Returns
    (launches at init, launches in all, the number of RF targets,
    sampler, states, generator)."""
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
    count = cycles * clen
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
    RATES[name] = stats['proposals_per_s']
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
    if not (np.isfinite(stats['proposals_per_s'])
            and stats['fwd_reject_pct'] < 100.0
            and (stats['fwd_reject_dim_pct'] or 0.0) < 100.0):
        raise AssertionError('%s: rate %s, reject shares %s / %s %%'
                             % (name, stats['proposals_per_s'],
                                stats['fwd_reject_pct'],
                                stats['fwd_reject_dim_pct']))
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


def check_public_forward(torch, dev):
    """(f): the public forward on the card, launch counts set to 0
    before and read after: ``SurfDisp.run_model`` of the tutorial truth
    model against the four dispersion goldens (1e-4 phase, 5e-4 Rayleigh
    group, 1e-3 Love group, tests/test_swd.py:35-36), ``SynRF.run_model``
    against the P-RF (2e-4, tests/test_targets.py:37) and S-RF (1e-4,
    :func:`check_golden`'s) goldens, all without a device argument; then
    ``surfdisp_batch`` of the 10,240 grown models for Rayleigh group
    velocity, spherical Rayleigh phase velocity and mode 2, host clock
    per synchronised call (median of ``PUBLIC_CALLS`` after one), 64
    models against the CPU twins.  Returns the launch counts."""
    from bayhunter_tpu_torch import Targets, bench_config
    from bayhunter_tpu_torch.ops import swd

    reset_counts()
    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77
    errs = {}
    for ref, tol in PUBLIC_TOLS.items():
        obs = np.loadtxt(os.path.join(bench_config.FIXTURES,
                                      'st3_%s.dat' % ref))
        plugin = bench_config.TARGETS[ref](obs[:, 0], None).moddata.plugin
        if plugin.device is not None:
            raise AssertionError('%s plugin on %s' % (ref, plugin.device))
        x, y = plugin.run_model(h, vp, vs, rho)
        errs[ref] = float(np.abs(np.asarray(y) - obs[:, 1]).max())
    log('public forward, SurfDisp / SynRF goldens, max |err| '
        + json.dumps(errs) + ' (limits ' + json.dumps(PUBLIC_TOLS) + ')')
    if not all(errs[k] <= PUBLIC_TOLS[k] for k in PUBLIC_TOLS):
        raise AssertionError('the plugins miss the golden data')

    (h, vp, vs, rho), _, _ = grown_layers(torch, dev)
    stats = {}
    # mode 2 at the periods of tests/test_swd.py:131-132 (the first
    # higher mode of these models leaves [cm, betmx] at long periods)
    for case, kw, tol, periods in (
            ('rayleigh_group', dict(igr=1), 1e-3, np.linspace(1, 41, 21)),
            ('rayleigh_spherical', dict(iflsph=1), 1e-4,
             np.linspace(1, 41, 21)),
            ('rayleigh_mode2', dict(mode=2), 1e-4, np.linspace(1, 10, 10))):
        periods = periods.astype(np.float32)
        seconds = []
        for _ in range(PUBLIC_CALLS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cg, err = swd.surfdisp_batch(h, vp, vs, rho, periods, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        pc, pe = swd.surfdisp_batch(*(x[:64].cpu() for x in (h, vp, vs,
                                                             rho)),
                                    periods, **kw)
        kc, ke = cg[:64].cpu(), err[:64].cpu()
        both = (kc > 0) & (pc > 0)
        d = float((kc - pc).abs()[both].max()) if bool(both.any()) else 0.0
        stats[case] = dict(
            seconds_per_call=seconds,
            models_per_s=C_MAIN / float(np.median(seconds[1:])),
            failed=int(err.sum()), finite=bool(torch.isfinite(cg).all()),
            max_err_vs_cpu_twins=d,
            err_flags_differ=int((ke != pe).sum()))
        if not (cg.shape == (C_MAIN, len(periods))
                and stats[case]['finite']
                and d <= tol and int((ke != pe).sum()) <= 2
                and int(err.sum()) < C_MAIN):
            raise AssertionError('surfdisp_batch (%s): %s' % (
                case, json.dumps(stats[case])))
    launches = launch_counts()
    log('public forward, surfdisp_batch of %d models: %s, launches %s'
        % (C_MAIN, json.dumps(stats), json.dumps(launches)))
    if not (launches['K4'] and launches['K5'] and launches['K3']
            and launches['K6']):
        raise AssertionError('the public forward missed a kernel')
    return launches


def counted_init(sampler):
    """The launch counts now, in a dict that ``sampler``'s cold init
    (``init_states_host``, wrapped here) updates when it returns."""
    at_init = launch_counts()
    init = sampler.init_states_host

    def counted(*a, **kw):
        out = init(*a, **kw)
        at_init.update(launch_counts())
        return out

    sampler.init_states_host = counted
    return at_init


def run_optimizer(torch, targets, priors, ip, seed, cls=None,
                  resume=False, devices=None, files=True, dtype=None):
    """One ``mp_inversion`` with the launch counts set to 0 before, on
    the first card or split over ``devices`` (the workers' counts then,
    and none in this process), writing its files or (``files`` False)
    keeping its snapshots, at ``dtype`` when given; returns (optimizer,
    wall seconds, launches at the end of the cold init, launches in
    all)."""
    from bayhunter_tpu_torch import MCMC_Optimizer
    cls = cls or MCMC_Optimizer
    where = dict(devices=devices) if devices else dict(
        device=torch.device(CARD))
    if dtype is not None:
        where['dtype'] = dtype
    reset_counts()
    opt = cls(targets, ip, priors, random_seed=seed, **where) if files \
        else cls.without_files(targets, ip, priors, seed, **where)
    at_init = None if devices else counted_init(opt.sampler)
    # the seconds of the .npy writing, which count in the run's wall
    # time, and the snapshots written (``opt.saved``, by phase tag)
    save = opt._save_phase
    opt.saved = {}

    def timed_save(snaps, tag):
        t = time.perf_counter()
        save(snaps, tag)
        opt.save_seconds = getattr(opt, 'save_seconds', 0.0) \
            + time.perf_counter() - t
        opt.saved[tag] = snaps

    opt._save_phase = timed_save
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.mp_inversion(resume=resume)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not devices:
        return opt, wall, at_init, launch_counts()
    if any(launch_counts().values()):
        raise AssertionError('a split run launched kernels in its parent')
    return (opt, wall, worker_counts(opt.worker_reports, 'launches_at_init'),
            worker_counts(opt.worker_reports))


def optimizer_stats(opt, wall):
    """Rate, acceptance and forward rejects of a finished run (the
    counters of both phases)."""
    st = opt.final_states
    acc, pp, ff = (x.sum(0).cpu().numpy().astype(np.float64)
                   for x in (st.accepted, st.proposed, st.fwdfail))
    save = getattr(opt, 'save_seconds', 0.0)
    return dict(chains=opt.nchains, iterations=opt.iterations,
                wall_s=wall, npy_write_s=save,
                proposals_per_s=opt.nchains * opt.iterations / wall,
                proposals_per_s_without_writing=opt.nchains
                * opt.iterations / (wall - save),
                accept_pct=(100.0 * acc / np.maximum(pp, 1)).tolist(),
                vpvs_accept_pct=100.0 * acc[4] / max(pp[4], 1.0),
                fwd_reject_pct=100.0 * ff.sum() / max(pp.sum(), 1.0),
                fwd_reject_dim_pct=100.0 * ff[2] / max(pp[2], 1.0))


def check_contract(opt, extra=()):
    """The ``.npy`` contract of a finished run: exactly the files of
    every chain and phase, the config pickle and the files named in
    ``extra``, each chain's float32 of its shape, models NaN beyond each
    snapshot's nucleus count, vp/vs inside its prior, finite likes and
    misfits.  Each file is read once, whole: its header must be the one
    ``np.save`` writes for a float32 array of its shape (C order), so
    another dtype or shape fails."""
    import io
    path, nl, T = opt.savepath, opt.maxlayers, opt.ntargets
    want = {'%s_config.pkl' % opt.station} | set(extra)
    plans = {}
    for tag, niter in (('p1', opt.iter_phase1), ('p2', opt.iter_phase2)):
        S = opt._phase_plan(niter)[1]
        if S:
            plans[tag] = S
            want |= {'c%.3d_%s%s.npy' % (c, tag, k)
                     for c in range(opt.nchains) for k in SNAP_NAMES}
    got = set(os.listdir(path))
    if got != want:
        raise AssertionError('%s: %d files missing, %d unexpected' % (
            path, len(want - got), len(got - want)))
    shapes = dict(models=(2 * nl,), likes=(), misfits=(T + 1,),
                  noise=(2 * T,), vpvs=())
    heads = {}        # the header np.save writes, and the array's size
    for tag, S in plans.items():
        for k in SNAP_NAMES:
            zeros = np.zeros((S,) + shapes[k], np.float32)
            buf = io.BytesIO()
            np.lib.format.write_array(buf, zeros)
            heads[tag, k] = (zeros.shape, buf.getvalue()[:-zeros.nbytes],
                             zeros.nbytes)
    prior = opt.priors['vpvs']
    lo, hi = (prior, prior) if np.isscalar(prior) else prior
    idx = np.arange(nl)
    for c in range(opt.nchains):
        for tag in plans:
            arr = {}
            for k in SNAP_NAMES:
                shape, head, size = heads[tag, k]
                name = 'c%.3d_%s%s.npy' % (c, tag, k)
                with open(os.path.join(path, name), 'rb') as f:
                    data = f.read()
                if not (data.startswith(head)
                        and len(data) == len(head) + size):
                    raise AssertionError('%s: not a float32 array of shape '
                                         '%s' % (name, shape))
                arr[k] = np.frombuffer(data, np.float32,
                                       offset=len(head)).reshape(shape)
            vs, z = arr['models'][:, :nl], arr['models'][:, nl:]
            n = np.isfinite(vs).sum(axis=1)
            padded = idx[None, :] >= n[:, None]
            if not (np.array_equal(np.isnan(vs), padded)
                    and np.array_equal(np.isnan(z), padded)
                    and n.min() >= 1):
                raise AssertionError('c%.3d_%smodels: not NaN beyond n'
                                     % (c, tag))
            v = arr['vpvs']
            if not (np.all(v >= np.float32(lo)) and np.all(v <= np.float32(hi))
                    and np.isfinite(arr['likes']).all()
                    and np.isfinite(arr['misfits']).all()):
                raise AssertionError('c%.3d_%s: vp/vs outside its prior or '
                                     'non-finite likes' % (c, tag))
    return plans


def final_files(path):
    """The files ``PlotFromStorage.save_final_distribution`` wrote into
    the data directory ``path``: the pooled ``c_*.npy`` arrays, and
    ``outliers.dat`` where it found outlier chains."""
    return tuple('c_%s.npy' % k for k in SNAP_NAMES) + tuple(
        f for f in ('outliers.dat',) if os.path.exists(os.path.join(path, f)))


def same_outputs(a, b, every=1):
    """Whether two runs' ``.npy`` files (those of every ``every``-th
    chain) are equal byte for byte."""
    names = sorted(f for f in os.listdir(a) if f.endswith('.npy'))
    if names != sorted(f for f in os.listdir(b) if f.endswith('.npy')):
        return False
    for f in names:
        if int(f[1:f.index('_')]) % every:
            continue
        with open(os.path.join(a, f), 'rb') as fa, \
                open(os.path.join(b, f), 'rb') as fb:
            if fa.read() != fb.read():
                return False
    return True


def same_snapshots(x, y):
    """Whether two runs handed bit-for-bit equal snapshots to their
    ``.npy`` writer (``run_optimizer``'s ``opt.saved``)."""
    return x.keys() == y.keys() and all(
        x[t].keys() == y[t].keys() and all(
            np.array_equal(x[t][k], y[t][k], equal_nan=True)
            and x[t][k].dtype == y[t][k].dtype for k in x[t])
        for t in x)


def same_states(torch, x, y):
    from bayhunter_tpu_torch import convert
    fields = convert.FLOAT_FIELDS + convert.INT_FIELDS
    return (all(torch.equal(getattr(x, f), getattr(y, f)) for f in fields)
            and all(torch.equal(a, b) for ca, cb in zip(x.cache, y.cache)
                    for a, b in zip(ca, cb)))


def on_cpu(states):
    """A copy of ``states`` on the CPU."""
    from bayhunter_tpu_torch import convert
    return convert.state_from_numpy(convert.state_to_numpy(states), 'cpu')


class Stopped(Exception):
    """Ends a run right after a checkpoint, as a lost process would."""


def stopped_and_resumed(torch, targets, priors, ip, stop, tag):
    """A run of ``ip`` (checkpointing after every segment) that stops at
    its ``stop``-th checkpoint, as a lost process would, and a new
    optimizer that resumes it; returns ((phase, iterations done) of the
    checkpoint, the resumed optimizer, its wall seconds)."""
    from bayhunter_tpu_torch import MCMC_Optimizer

    class StopsAtCheckpoint(MCMC_Optimizer):
        written = 0

        def save_checkpoint(self, *a, **kw):
            super().save_checkpoint(*a, **kw)
            StopsAtCheckpoint.written += 1
            if StopsAtCheckpoint.written == stop:
                raise Stopped

    try:
        run_optimizer(torch, targets, priors, ip, OPT_SEED,
                      cls=StopsAtCheckpoint)
        raise AssertionError('%s: the second run did not stop' % tag)
    except Stopped:
        pass
    with np.load(os.path.join(ip['savepath'], 'data',
                              'checkpoint.npz')) as ck:
        where = (int(ck['phase']), int(ck['it_done']))
    opt, wall, _, _ = run_optimizer(torch, targets, priors, ip, OPT_SEED,
                                    resume=True)
    return where, opt, wall


def same_run(torch, a, b):
    """Whether two finished runs handed their ``.npy`` writers the same
    snapshots, wrote the same bytes (every 64th chain's files) and ended
    in the same states."""
    return (same_snapshots(a.saved, b.saved)
            and same_outputs(a.savepath, b.savepath, every=64)
            and same_states(torch, a.final_states, b.final_states))


def optimizer_tutorial(torch, tmp):
    """(b): the tutorial configuration through ``mp_inversion``: the
    contract of a run at 10,240 chains, 2,048 + 1,024 iterations; then,
    cut to ``OPT_RESUME_CHAINS`` chains and ``OPT_RESUME_ITERS``, an
    uninterrupted run, a run that stops at its ``OPT_STOP_B``-th
    checkpoint (mid burn-in) and a new optimizer that resumes it, bit
    for bit equal to the uninterrupted one (the resume carries the
    segment, the generator's state and the resort map, none of which
    depends on the width or the length of the run).  Logs each part's
    wall seconds.  Returns the first run's (stats, launches at init,
    launches)."""
    from bayhunter_tpu_torch import bench_config
    t_b = time.perf_counter()
    targets, _ = bench_config.tutorial_targets()
    priors, ip = bench_config.tutorial_params()
    ip.update(nchains=C_MAIN, iter_burnin=OPT_ITERS_B[0],
              iter_main=OPT_ITERS_B[1], maxmodels=64,
              segment_iters=OPT_SEGMENT_B, checkpoint_seconds=0,
              savepath=os.path.join(tmp, 'b1'))
    seconds = {}
    t = time.perf_counter()
    opt, wall, at_init, counts = run_optimizer(torch, targets, priors, ip,
                                               OPT_SEED)
    seconds['contract_run'] = time.perf_counter() - t
    t = time.perf_counter()
    plans = check_contract(opt)
    seconds['contract_check'] = time.perf_counter() - t
    stats = optimizer_stats(opt, wall)
    stats.update(snapshots=plans, main_path_proposals_per_s=RATES.get(
        'tutorial'), launches=counts)
    del opt

    ip2 = dict(ip, nchains=OPT_RESUME_CHAINS,
               iter_burnin=OPT_RESUME_ITERS[0],
               iter_main=OPT_RESUME_ITERS[1],
               maxmodels=OPT_RESUME_MAXMODELS,
               segment_iters=OPT_RESUME_SEGMENT,
               savepath=os.path.join(tmp, 'b2'))
    t = time.perf_counter()
    ref, _, _, _ = run_optimizer(torch, targets, priors, ip2, OPT_SEED)
    seconds['resume_reference'] = time.perf_counter() - t
    ip3 = dict(ip2, checkpoint_seconds=1e-9,
               savepath=os.path.join(tmp, 'b3'))
    t = time.perf_counter()
    where, resumed, wall3 = stopped_and_resumed(torch, targets, priors, ip3,
                                                OPT_STOP_B, '(b)')
    seconds['stopped_and_resumed'] = time.perf_counter() - t
    if where != (1, OPT_STOP_B * OPT_RESUME_SEGMENT):
        raise AssertionError('(b): checkpoint at %s' % (where,))
    # the resumed run handed its writer the same snapshots, bit for bit,
    # of every chain as the uninterrupted run (np.save writes equal
    # arrays as equal bytes: every 64th chain's files are compared too)
    t = time.perf_counter()
    if not same_run(torch, ref, resumed):
        raise AssertionError('(b): the resumed run differs from the '
                             'uninterrupted one')
    seconds['resume_compare'] = time.perf_counter() - t
    stats['resume'] = dict(chains=OPT_RESUME_CHAINS,
                           iterations=OPT_RESUME_ITERS, stopped_at=where,
                           resumed_wall_s=wall3, bitwise=True)
    seconds['b'] = time.perf_counter() - t_b
    stats['seconds'] = seconds
    log('optimizer (b), tutorial: ' + json.dumps(stats))
    log('(b) took %.1f s' % seconds['b'])
    return stats, at_init, counts


def swap_schedule(torch, opt):
    """swap_proposed summed over a finished tempered run's chains,
    counted from its schedule: the sweeps that ``chain.cycle_moves``
    places in each pinned segment of each phase, times the pairs of
    their parity (rungs t, t + 1 with t of the parity), times the
    temperature groups; and the number of sweeps."""
    from bayhunter_tpu_torch.sampler import chain
    sp, ntemps = opt.sampler, opt.ntemps
    pairs = [sum(1 for t in range(ntemps - 1) if t % 2 == p) for p in (0, 1)]
    seg = int(opt.initparams['segment_iters'])
    gen = torch.Generator()      # remainders' uniforms place no sweep
    total = sweeps = 0
    it = -opt.iter_phase1
    for niter in (opt.iter_phase1, opt.iter_phase2):
        thin = opt._phase_plan(niter)[0]
        if thin < len(sp.late_order):
            raise AssertionError('(i-1): thin %d runs no sweeps' % thin)
        for done in range(0, niter, seg):
            for m in chain.cycle_moves(sp, it + done, min(seg, niter - done),
                                       gen):
                if isinstance(m, chain.Sweep):
                    total += pairs[m.parity]
                    sweeps += 1
        it += niter
    return total * (opt.nchains_total // ntemps), sweeps


def optimizer_tempered(torch, tmp):
    """(i-1): the tutorial under parallel tempering
    (``bench_config.build_tempered``: 2,560 posterior chains x 4 rungs =
    10,240 on the card, ``TEMPERED_ITERS``, a sweep after
    every cycle, the burn-in ladder adaptation) through ``mp_inversion``:
    the ``.npy`` contract of the 2,560 cold chains alone, finite swap rates
    in [0, 1] with swaps accepted, the swap proposals the schedule
    places, the adapted ladder anchored and monotone, the cold rung's
    median logL above the hottest's, and a run stopped mid burn-in and
    resumed bit for bit.  Returns (stats, launches at init, launches)."""
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.sampler import tempering
    targets, priors, ip = bench_config.build_tempered()
    ip.update(iter_burnin=TEMPERED_ITERS[0], iter_main=TEMPERED_ITERS[1],
              maxmodels=TEMPERED_MAXMODELS, segment_iters=TEMPERED_SEGMENT,
              checkpoint_seconds=0, savepath=os.path.join(tmp, 'i1'))
    opt, wall, at_init, counts = run_optimizer(torch, targets, priors, ip,
                                               OPT_SEED)
    # exactly c000 ... c2559 of every phase: no c2560_*
    plans = check_contract(opt)
    st, ntemps = opt.final_states, opt.ntemps
    sacc = st.swap_accepted.cpu().numpy()
    sprop = st.swap_proposed.cpu().numpy()
    rates, nprop = tempering.rung_swap_rates(sacc, sprop, ntemps)
    want, sweeps = swap_schedule(torch, opt)
    betas = opt.tempering_plan.betas[:ntemps]
    logL = st.logL.cpu().numpy()
    cold, hot = (float(np.median(logL[r::ntemps])) for r in (0, ntemps - 1))
    stats = optimizer_stats(opt, wall)
    stats.update(
        device_chains=opt.nchains_total, snapshots=plans,
        proposals_per_s_device_chains=opt.nchains_total * opt.iterations
        / wall, swap_rates=rates.tolist(), swap_proposed_per_gap=nprop.tolist(),
        swaps_accepted=int(sacc.sum()), swaps_proposed=int(sprop.sum()),
        swaps_proposed_by_schedule=want, sweeps=sweeps,
        ladder_betas=betas.tolist(), ladder_updates=opt._ladder_nupd,
        logL_median_cold=cold, logL_median_hottest=hot, launches=counts)
    log('optimizer (i-1), tempered tutorial: ' + json.dumps(stats))
    bad = []
    if not (np.all(np.isfinite(rates)) and np.all((rates >= 0)
                                                  & (rates <= 1))
            and sacc.sum() > 0):
        bad.append('swap rates')
    if int(sprop.sum()) != want:
        bad.append('swap proposals %d, the schedule places %d'
                   % (sprop.sum(), want))
    # the adaptation starts from the states' float32 betas, so the hot
    # anchor is 1/1000 rounded to float32 (to float64's rounding)
    if not (opt._ladder_nupd >= 1 and betas[0] == 1.0
            and abs(betas[-1] / np.float32(1e-3) - 1.0) < 1e-12
            and np.all(np.diff(betas) < 0)
            and np.array_equal(st.beta.cpu().numpy(), np.tile(
                betas, opt.nchains).astype(np.float32))):
        bad.append('the ladder %s' % betas.tolist())
    if not cold > hot:
        bad.append('cold logL %.1f not above the hottest %.1f' % (cold, hot))
    missing = [k for k in ('K1', 'K2_rayleigh', 'K3', 'K4', 'K6')
               if counts[k] == 0]
    if missing:
        bad.append('kernels %s never launched' % missing)
    if bad:
        raise AssertionError('(i-1): ' + '; '.join(bad))

    ip2 = dict(ip, checkpoint_seconds=1e-9, savepath=os.path.join(tmp, 'i2'))
    where, opt3, wall3 = stopped_and_resumed(torch, targets, priors, ip2,
                                             TEMPERED_STOP, '(i-1)')
    if where != (1, TEMPERED_STOP * TEMPERED_SEGMENT):
        raise AssertionError('(i-1): checkpoint at %s' % (where,))
    if not (same_run(torch, opt, opt3) and np.array_equal(
            opt.tempering_plan.betas, opt3.tempering_plan.betas)):
        raise AssertionError('(i-1): the resumed tempered run differs from '
                             'the uninterrupted one')
    log('optimizer (i-1): stopped at %s, resumed bit for bit in %.1f s'
        % (where, wall3))
    return stats, at_init, counts


def tomo_run(torch, dev):
    """(i-2): ``TomoInversion`` of ``bench_config.build_tomo`` (1,000
    cells x 100 chains = 100,000 chains, data made on the card), its
    cold init timed, held to tests/test_tomo.py's bound at 5 km for the
    median over each family's cells and for 90 % of the cells against
    their own family, every cell's median logL above -1e4; then K1's and
    K2's device time per launch (profiler) at 100,000 chains beside
    10,240 of them.  Returns (stats, launches at init, launches)."""
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.ops import prep, swd
    from bayhunter_tpu_torch.sampler import evaluator
    tomo = bench_config.build_tomo(device=dev)
    C = tomo.nchains
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = {}
    init = tomo.sampler.init_states_host

    def timed_init(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = init(*a, **kw)
        torch.cuda.synchronize()
        rec['cold_init_s'] = time.perf_counter() - t
        rec['at_init'] = launch_counts()
        return out

    tomo.sampler.init_states_host = timed_init
    t0 = time.perf_counter()
    out = tomo.run(segment_iters=TOMO_SEGMENT, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = tomo.final_states
    (d0, t_0), (d1, t_1) = tomo.progress[-2:]

    vs5 = out['vs_median'][:, np.argmin(np.abs(out['depth'] - TOMO_DEPTH))]
    family = np.arange(tomo.ncells) % 2
    truth = np.array([t['vs'][0] for t in bench_config.TOMO_TRUTHS])
    fam_median = [float(np.median(vs5[family == f])) for f in (0, 1)]
    share = float(np.mean(np.abs(vs5 - truth[family]) < TOMO_BOUND))
    state_bytes = nbytes(*(getattr(st, f) for f in (
        'vs', 'z', 'n', 'vpvs', 'noise', 'logL', 'misfits', 'propdist',
        'accepted', 'proposed', 'fwdfail', 'iiter', 'beta', 'cell',
        'swap_accepted', 'swap_proposed')), *sum(st.cache, ()))

    # K1 (the dispersion set alone) and K2 (Rayleigh, the vs setting) at
    # the final states, all 100,000 chains and the first 10,240
    ev, spec = tomo.eval_fn, tomo.eval_fn.specs[0]
    device_ms = {}
    for width in (C, C_MAIN):
        nuc = (st.vs[:width].T.contiguous(), st.z[:width].T.contiguous(),
               st.n[:width].contiguous(), st.vpvs[:width].contiguous())
        _, sets, _ = prep.model_operands(*nuc, ev.priors, (), ev.swd_specs)
        props, cm, bx, top, rho = (None if x is None else x.clone()
                                   for x in sets[0])
        roots = st.cache[0][1][:width].contiguous()
        slopes = st.cache[0][2][:width].contiguous()
        device_ms[width] = dict(
            K1=profiled(lambda: prep.model_operands(
                *nuc, ev.priors, (), ev.swd_specs), KERNEL_REPS,
                KERNEL_NAMES['K1']),
            K2=profiled(lambda: swd.warm_solve(
                props, cm, bx, top, spec.omegas, roots, swd.WARM_VS,
                slope_prev=slopes, iwave=spec.iwave, rho=rho), KERNEL_REPS,
                KERNEL_NAMES['K2']))
    stats = dict(
        cells=tomo.ncells, chains=C, iterations=d1, wall_s=wall,
        cold_init_s=rec['cold_init_s'],
        cold_init_chunks=-(-C // evaluator.COLD_CHUNK),
        cold_init_launches=rec['at_init'],
        late_proposals_per_s=C * (d1 - d0) / (t_1 - t_0),
        proposals_per_s=C * d1 / tomo.progress[-1][1],
        peak_device_bytes=peak, state_bytes=state_bytes,
        vs_at_5km_family_medians=fam_median,
        cells_within_bound_share=share,
        logL_median_min=float(out['logL_median'].min()),
        device_ms_per_launch={str(k): v for k, v in device_ms.items()},
        launches=counts)
    log('tomography (i-2), 1,000 cells x 100 chains: ' + json.dumps(stats))
    bad = []
    if out['vs_median'].shape != (tomo.ncells, 121):
        bad.append('vs_median of shape %s' % (out['vs_median'].shape,))
    if not all(abs(m - v) < TOMO_BOUND for m, v in zip(fam_median, truth)):
        bad.append('family medians %s at 5 km, truths %s'
                   % (fam_median, truth.tolist()))
    if share < TOMO_CELL_SHARE:
        bad.append('%.3f of the cells within %.2f of their truth'
                   % (share, TOMO_BOUND))
    if not np.all(out['logL_median'] > -1e4):
        bad.append('a cell\'s median logL at %.1f' % stats['logL_median_min'])
    missing = [k for k in ('K1', 'K2_rayleigh', 'K4') if counts[k] == 0]
    if missing:
        bad.append('kernels %s never launched' % missing)
    if bad:
        raise AssertionError('(i-2): ' + '; '.join(bad))
    # (k-1) holds its split run to these
    stats['final_states'] = on_cpu(st)
    stats['summary'] = out
    return stats, rec['at_init'], counts


def split_devices(torch):
    """(k)'s two entries: two GPUs where there are, else the first one
    twice (two workers on one card)."""
    n = torch.cuda.device_count()
    return ['cuda:0', 'cuda:1'] if n >= 2 else ['cuda:0', 'cuda:0']


def worker_stats(reports):
    """Each worker's rows, device, peak device bytes and the launches of
    its path's kernels."""
    keep = ('K1', 'K2_rayleigh', 'K3', 'K4', 'K6')
    return [dict(rows=rep['rows'], device=rep['device'],
                 peak_device_bytes=rep['peak_bytes'],
                 launches={k: v for k, v in launch_counts(
                     rep['launches']).items() if k in keep})
            for rep in reports]


def split_tomo(torch, devs, ref):
    """(k-1): ``tomo_1000x100`` split over ``devs`` (100,000 chains, the
    seeds and iterations of (i-2)): every field of the final states and
    every array of the summary bit for bit equal to (i-2)'s one-device
    run ``ref``; its wall time and late proposals/s beside (i-2)'s, each
    worker's peak memory and launches.  Returns (stats, launches at
    init, launches), the workers' summed."""
    from bayhunter_tpu_torch import bench_config
    tomo = bench_config.build_tomo(devices=devs)
    reset_counts()
    t0 = time.perf_counter()
    out = tomo.run(segment_iters=TOMO_SEGMENT, log_every=1)
    wall = time.perf_counter() - t0
    (d0, t_0), (d1, t_1) = tomo.progress[-2:]
    at_init = worker_counts(tomo.worker_reports, 'launches_at_init')
    counts = worker_counts(tomo.worker_reports)
    stats = dict(
        devices=devs, chains=tomo.nchains, iterations=d1, wall_s=wall,
        wall_s_one_device=ref['wall_s'],
        late_proposals_per_s=tomo.nchains * (d1 - d0) / (t_1 - t_0),
        late_proposals_per_s_one_device=ref['late_proposals_per_s'],
        workers=worker_stats(tomo.worker_reports), pool=tomo.pool_stats,
        parent_launches=sum(launch_counts().values()), launches=counts)
    log('split (k-1), tomo_1000x100 over %s: %s' % (devs, json.dumps(stats)))
    bad = []
    if not same_states(torch, tomo.final_states, ref['final_states']):
        bad.append('final states differ from (i-2)')
    want = ref['summary']
    if sorted(out) != sorted(want) or not all(
            out[k].dtype == want[k].dtype and np.array_equal(out[k], want[k])
            for k in want):
        bad.append('the summary differs from (i-2)')
    if stats['parent_launches']:
        bad.append('the parent launched kernels')
    missing = [k for k in ('K1', 'K2_rayleigh', 'K4') if counts[k] == 0]
    if missing:
        bad.append('kernels %s never launched' % missing)
    if bad:
        raise AssertionError('(k-1): ' + '; '.join(bad))
    return stats, at_init, counts


def same_files_as(path, snaps, nchains):
    """(whether ``path`` holds exactly the ``.npy`` files of ``nchains``
    chains of the phases of ``snaps`` (``snapshots[tag]`` of a run
    without files) and each file is, byte for byte, what ``np.save``
    writes for its snapshot (so every array bit for bit), seconds
    taken).  A file of a C-ordered array is its header, the same for
    every chain of a phase and name, and the array's bytes; the files
    are read by 16 threads."""
    import concurrent.futures
    import io
    t = time.perf_counter()
    want = {'c%.3d_%s%s.npy' % (c, tag, name)
            for tag in snaps for c in range(nchains)
            for name in SNAP_NAMES}
    if {f for f in os.listdir(path) if f.endswith('.npy')} != want:
        return False, time.perf_counter() - t
    keys = dict(models='model', likes='logL', misfits='misfits',
                noise='noise', vpvs='vpvs')

    def saved(arr):
        buf = io.BytesIO()
        np.lib.format.write_array(buf, arr, allow_pickle=False)
        return buf.getvalue()

    heads = {}
    for tag in snaps:
        for name in SNAP_NAMES:
            arr = np.asarray(snaps[tag][keys[name]][0], np.float32)
            heads[tag, name] = arr.shape, saved(arr)[:-arr.nbytes or None]

    def chain_equal(job):
        tag, c = job
        for name in SNAP_NAMES:
            arr = np.asarray(snaps[tag][keys[name]][c], np.float32)
            shape, head = heads[tag, name]
            want = head + arr.tobytes() if (
                arr.shape == shape and arr.flags.c_contiguous
                and arr.nbytes) else saved(arr)
            with open(os.path.join(path, 'c%.3d_%s%s.npy'
                                   % (c, tag, name)), 'rb') as f:
                if f.read() != want:
                    return False
        return True

    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        same = all(pool.map(chain_equal, [(tag, c) for tag in snaps
                                          for c in range(nchains)]))
    return same, time.perf_counter() - t


def split_optimizer(torch, devs, tmp):
    """(k-2): (b)'s configuration at 10,240 chains, resort off, its
    segment pinned, ``SPLIT_ITERS``: ``mp_inversion`` split over
    ``devs`` writes the files, and every array of every file equals the
    snapshot of the same run on one card without files, bit for bit, as
    do the final states; then the tempered tutorial
    (``build_tempered``'s 2,560 x 4 chains, resort off, sweeps and the
    ladder adaptation, ``SPLIT_TEMPERED_ITERS``) in memory, split and
    on one card: equal snapshots, final states (swap counters among
    them) and ladder.  Returns (stats, launches at init, launches) of
    the split runs, summed over their workers, and (launches at init,
    launches) of the one-card runs."""
    from bayhunter_tpu_torch import bench_config
    targets, _ = bench_config.tutorial_targets()
    priors, ip = bench_config.tutorial_params()
    ip.update(nchains=C_MAIN, iter_burnin=SPLIT_ITERS[0],
              iter_main=SPLIT_ITERS[1], maxmodels=SPLIT_MAXMODELS,
              segment_iters=SPLIT_SEGMENT, checkpoint_seconds=0,
              resort_chains=False, savepath=os.path.join(tmp, 'k'))
    split, wall, init_s, all_s = run_optimizer(
        torch, targets, priors, ip, OPT_SEED, devices=devs)
    one, wall1, init_1, all_1 = run_optimizer(
        torch, targets, priors, ip, OPT_SEED, files=False)
    states_equal = same_states(torch, split.final_states,
                               on_cpu(one.final_states))
    stats = dict(devices=devs, chains=C_MAIN, iterations=split.iterations,
                 wall_s=wall, npy_write_s=split.save_seconds,
                 wall_s_one_device_without_files=wall1,
                 workers=worker_stats(split.worker_reports),
                 pool=split.pool_stats, launches=all_s)

    # the files are read back in a thread while the tempered split runs
    # (its workers hold the card; this process mostly waits on pipes)
    import concurrent.futures
    reader = concurrent.futures.ThreadPoolExecutor(1)
    files = reader.submit(same_files_as, split.savepath, one.snapshots,
                          C_MAIN)
    reader.shutdown(wait=False)
    targets, priors, ipt = bench_config.build_tempered()
    ipt.update(iter_burnin=SPLIT_TEMPERED_ITERS[0],
               iter_main=SPLIT_TEMPERED_ITERS[1],
               maxmodels=SPLIT_TEMPERED_MAXMODELS,
               segment_iters=SPLIT_TEMPERED_SEGMENT, resort_chains=False)
    tsplit, twall, tinit_s, tall_s = run_optimizer(
        torch, targets, priors, ipt, OPT_SEED, devices=devs, files=False)
    tone, twall1, tinit_1, tall_1 = run_optimizer(
        torch, targets, priors, ipt, OPT_SEED, files=False)
    tstate = tsplit.final_states
    tempered_equal = (
        same_snapshots(tsplit.snapshots, tone.snapshots)
        and same_states(torch, tstate, on_cpu(tone.final_states))
        and np.array_equal(tsplit.tempering_plan.betas,
                           tone.tempering_plan.betas))
    stats['tempered'] = dict(
        device_chains=tsplit.nchains_total, iterations=tsplit.iterations,
        wall_s=twall, wall_s_one_device=twall1,
        swaps_proposed=int(tstate.swap_proposed.sum()),
        swaps_accepted=int(tstate.swap_accepted.sum()),
        ladder_updates=tsplit._ladder_nupd,
        workers=worker_stats(tsplit.worker_reports), pool=tsplit.pool_stats,
        launches=tall_s)
    files_equal, stats['files_compared_s'] = files.result()
    log('split (k-2), tutorial optimizer over %s: %s'
        % (devs, json.dumps(stats)))
    bad = []
    if not files_equal:
        bad.append('the split run\'s files differ from the one-card '
                   'snapshots')
    if not states_equal:
        bad.append('the split run\'s final states differ')
    if not tempered_equal:
        bad.append('the tempered split differs from its one-card run')
    if not (stats['tempered']['swaps_proposed'] > 0
            and tsplit._ladder_nupd >= 1):
        bad.append('the tempered split ran no sweep or no adaptation')
    for name, c in (('split', all_s), ('tempered split', tall_s)):
        missing = [k for k in ('K1', 'K2_rayleigh', 'K3', 'K4', 'K6')
                   if c[k] == 0]
        if missing:
            bad.append('%s: kernels %s never launched' % (name, missing))
    if bad:
        raise AssertionError('(k-2): ' + '; '.join(bad))

    def add(a, b):
        return {k: a[k] + b[k] for k in a}

    return (stats, add(init_s, tinit_s), add(all_s, tall_s),
            (add(init_1, tinit_1), add(all_1, tall_1)))


def split_step_cost(torch, dev):
    """(k-3): what a worker pays on the card for drawing every random
    tensor and running the batch-shape-dependent products (the
    dof-corrected Gaussian RF law's whitening, the RF DFT) at the
    one-card width: (k-2)'s sampler on the first half of its 10,240
    chains, late cycles timed with the block placed in the whole batch
    (``Sampler.rows``, as a worker runs it) and as a batch of its own,
    ``SPLIT_COST_ROUNDS`` rounds alternating placed, own, own, placed,
    ...; ms per iteration of each (median of its rounds)."""
    from bayhunter_tpu_torch import MCMC_Optimizer, bench_config
    from bayhunter_tpu_torch.sampler.chain import Rows, dispatch_cycles
    targets, _ = bench_config.tutorial_targets()
    priors, ip = bench_config.tutorial_params()
    ip.update(nchains=C_MAIN, iter_burnin=SPLIT_ITERS[0],
              iter_main=SPLIT_ITERS[1], resort_chains=False)
    sampler = MCMC_Optimizer.without_files(targets, ip, priors, OPT_SEED,
                                           device=dev).sampler
    placed = Rows(0, C_MAIN // 2, C_MAIN)
    sampler.rows = placed
    states, gen = sampler.init_states_host(OPT_SEED, C_MAIN)
    clen = len(sampler.late_order)
    count = SPLIT_COST_CYCLES * clen
    it = 0                       # the main phase: late cycles
    times = {'placed': [], 'own': []}
    for r in range(-2, SPLIT_COST_ROUNDS):     # two rounds of warm-up
        mode = 'placed' if r % 4 in (0, 3) else 'own'
        sampler.rows = placed if mode == 'placed' else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = dispatch_cycles(sampler, states, it, count, gen)
        torch.cuda.synchronize()
        if r >= 0:
            times[mode].append(1e3 * (time.perf_counter() - t0) / count)
        it += count
    sampler.rows = None
    stats = dict(block_rows=C_MAIN // 2, width=C_MAIN,
                 iterations_a_round=count,
                 ms_per_iter_placed=float(np.median(times['placed'])),
                 ms_per_iter_own=float(np.median(times['own'])),
                 rounds=times)
    stats['extra_ms_per_iter'] = (stats['ms_per_iter_placed']
                                  - stats['ms_per_iter_own'])
    log('split (k-3), a worker\'s step cost: ' + json.dumps(stats))
    if not bool(torch.isfinite(states.logL).all()):
        raise AssertionError('(k-3): non-finite logL')
    return stats


def optimizer_defaults(torch, tmp):
    """(c): ``defaults.ini``'s priors (the exponential RF law, vp/vs
    inverted) with the mantle prior and positive SWD errors (the
    scaled-error law), 10,240 chains, the contract."""
    from bayhunter_tpu_torch import bench_config
    targets, _ = bench_config.tutorial_targets(positive_errors=True)
    priors = {'mantle': MANTLE}
    ip = dict(nchains=C_MAIN, iter_burnin=OPT_ITERS_C[0],
              iter_main=OPT_ITERS_C[1], maxmodels=64,
              savepath=os.path.join(tmp, 'c'))
    opt, wall, at_init, counts = run_optimizer(torch, targets, priors, ip,
                                               OPT_SEED)
    laws = [s.cov for s in opt.eval_fn.specs]
    if laws != ['nocorr_scalederr', 'exp'] or opt.eval_fn.mantle != MANTLE:
        raise AssertionError('(c) runs laws %s, mantle %s' % (
            laws, opt.eval_fn.mantle))
    stats = optimizer_stats(opt, wall)
    stats.update(snapshots=check_contract(opt), laws=laws, launches=counts)
    log('optimizer (c), reference defaults + mantle: ' + json.dumps(stats))
    return stats, at_init, counts


def recovery_summary(opt):
    """The posterior summary of ``scripts/ab_layer_posterior.py`` on a
    finished run's main phase: the chains kept by the reference's
    outlier rule (median likelihood within 5 % of the best chain's,
    ``plotting.outlier_chains``), pooled, their better half by
    likelihood; the layer-count (nucleus) histogram and the medians of
    the noise and vp/vs."""
    from bayhunter_tpu_torch import plotting
    path, nl = opt.savepath, opt.maxlayers

    def load(c, k):
        return np.load(os.path.join(path, 'c%.3d_p2%s.npy' % (c, k)))

    med = np.array([np.median(load(c, 'likes')) for c in range(opt.nchains)])
    _, outlier = plotting.outlier_chains(med, POST_DEV)
    keep = [c for c in range(opt.nchains) if not outlier[c]]
    pooled = {k: np.concatenate([load(c, k) for c in keep])
              for k in ('models', 'likes', 'noise', 'vpvs')}
    good = pooled['likes'] >= np.median(pooled['likes'])
    nlay = np.isfinite(pooled['models'][good, :nl]).sum(axis=1)
    hist = np.bincount(nlay, minlength=nl + 1) / nlay.size
    mode = int(np.argmax(hist))
    return dict(chains_kept=len(keep), kept=keep, nlay_mode=mode,
                nlay_hist={int(i): float(p) for i, p in enumerate(hist)
                           if p > 0},
                p56=float(hist[5] + hist[6]),
                sigma_rf_median=float(np.median(pooled['noise'][good, 3])),
                sigma_swd_median=float(np.median(pooled['noise'][good, 1])),
                vpvs_median=float(np.median(pooled['vpvs'][good])))


def tutorial_run(torch, tmp, seed, nchains=21, schedule=None):
    """The tutorial as its users run it (``tutorial/tutorialhunt.py``:
    21 chains, 32,768 + 16,384 iterations unless ``schedule`` (burn-in,
    main) says otherwise, ``maxmodels`` 50,000) from ``seed``, its
    segment pinned at ``TUTORIAL_SEGMENT`` so that a seed gives one
    sample path on any host; returns (stats with the recovery summary,
    launches at init, launches)."""
    from bayhunter_tpu_torch import bench_config
    targets, sd = bench_config.tutorial_targets()
    priors, ip = bench_config.tutorial_params()
    ip.update(nchains=nchains, segment_iters=TUTORIAL_SEGMENT,
              savepath=os.path.join(tmp, 'd%d' % seed))
    if schedule is not None:
        ip.update(iter_burnin=schedule[0], iter_main=schedule[1])
    opt, wall, at_init, counts = run_optimizer(torch, targets, priors, ip,
                                               seed)
    stats = optimizer_stats(opt, wall)
    stats.update(seed=seed, sigma_swd_injected=sd,
                 snapshots=check_contract(opt), **recovery_summary(opt))
    return stats, at_init, counts


def optimizer_recovery(torch, tmp):
    """(d): the tutorial run of ``TUTORIAL_SEED`` at
    ``TUTORIAL_SCHEDULE``, held to ``RECOVERY_S``; whether its summary
    equals its seed's committed line in ``docs/posterior_S/port_S.json``
    (one sample path a seed) is logged."""
    stats, at_init, counts = tutorial_run(torch, tmp, TUTORIAL_SEED,
                                          schedule=TUTORIAL_SCHEDULE)
    stats['launches'] = counts
    log('optimizer (d), the tutorial at 21 chains: ' + json.dumps(stats))
    with open(os.path.join(ROOT, 'docs', 'posterior_S', 'port_S.json')) as f:
        [line] = [r for r in json.load(f) if r['seed'] == TUTORIAL_SEED]
    same = [k for k in RECOVERY_FIELDS
            if json.loads(json.dumps(stats[k])) == line[k]]
    log('(d) equals its seed\'s committed line at S in %d of %d fields%s'
        % (len(same), len(RECOVERY_FIELDS), '' if len(same) == len(
            RECOVERY_FIELDS) else ' (%s differ)' % sorted(
            set(RECOVERY_FIELDS) - set(same))))
    bad = [k for k, (lo, hi) in RECOVERY_S.items()
           if not lo <= stats[k] <= hi]
    if bad:
        raise AssertionError('(d): %s outside the recovery bands %s'
                             % (bad, RECOVERY_S))
    return stats, at_init, counts


def postprocess(torch, datapath, kept):
    """(j-1): the port's ``PlotFromStorage`` on (d)'s files, on the card
    and without matplotlib: ``save_final_distribution`` as
    ``tutorial/tutorialhunt.py`` calls it (its outliers the chains that
    ``recovery_summary`` dropped, ``kept`` the others),
    ``convergence_report`` and ``ModelMatrix.get_singlemodels`` of the
    pooled models with their joint misfits (the medians at
    ``POST_DEPTHS`` logged); then ``plotting.datafits`` of each kept
    chain's best and latest model on the card, launch counts set to 0
    before and read after, held to the same fits on the CPU at (f)'s
    bounds.  Returns the launch counts of the fits."""
    import glob
    from bayhunter_tpu_torch import ModelMatrix, PlotFromStorage, plotting

    [cfg] = glob.glob(os.path.join(datapath, '*_config.pkl'))
    t0 = time.perf_counter()
    post = PlotFromStorage(cfg)
    if post.device.type != 'cuda':
        raise AssertionError('PlotFromStorage on %s' % post.device)
    post.save_final_distribution(maxmodels=POST_MAXMODELS, dev=POST_DEV)
    t_final = time.perf_counter() - t0
    kept_post = [c for c in post.store.chains if c not in post.outliers]
    if kept_post != kept:
        raise AssertionError('PlotFromStorage keeps chains %s, the '
                             'recovery summary %s' % (kept_post, kept))
    rep = post.convergence_report()
    final = {k: np.load(os.path.join(datapath, 'c_%s.npy' % k))
             for k in ('models', 'misfits')}
    t1 = time.perf_counter()
    summary = ModelMatrix.get_singlemodels(final['models'],
                                           misfits=final['misfits'][:, -1])
    t_summary = time.perf_counter() - t1
    vs_med, dep = summary['median']
    medians = {str(d): float(vs_med[np.flatnonzero(dep == d)[0]])
               for d in POST_DEPTHS}
    nmod = len(final['models'])
    if not (0 < nmod <= POST_MAXMODELS
            and np.isfinite(vs_med).all()
            and set(summary) >= {'mean', 'median', 'mode', 'minmisfit'}):
        raise AssertionError('the final distribution: %d models' % nmod)

    picks = [(c, which) + getattr(post, '_%s_state' % which)(c)
             for c in kept for which in ('best', 'latest')]
    reset_counts()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    on_card = [plotting.datafits(post.targets, model, vpvs, post.mantle,
                                 post.device)
               for _, _, model, vpvs in picks]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t2
    launches = launch_counts()
    t3 = time.perf_counter()
    on_cpu = [plotting.datafits(post.targets, model, vpvs, post.mantle,
                                'cpu')
              for _, _, model, vpvs in picks]
    cpu_s = time.perf_counter() - t3
    errs = dict.fromkeys((t.ref for t in post.targets), 0.0)
    failed = 0
    for (c, which, _, _), card, cpu in zip(picks, on_card, on_cpu):
        for target, (xg, yg), (xc, yc) in zip(post.targets, card, cpu):
            ok_g, ok_c = (bool(np.all(np.isfinite(y))) for y in (yg, yc))
            if ok_g != ok_c:
                raise AssertionError('c%d %s %s: the card fit failed %s, '
                                     'the CPU fit %s' % (c, which,
                                                         target.ref,
                                                         not ok_g,
                                                         not ok_c))
            if not ok_g:
                failed += 1
                continue
            if not np.array_equal(xg, xc):
                raise AssertionError('%s: x differs' % target.ref)
            errs[target.ref] = max(errs[target.ref],
                                   float(np.abs(yg - yc).max()))
    nfits = len(picks) * len(post.targets)
    stats = dict(
        chains_kept=len(kept), models_pooled=nmod,
        final_distribution_s=t_final, summary_s=t_summary,
        convergence={k: {m: float(v[m]) for m in ('rhat', 'ess')}
                     for k, v in rep.items()},
        vs_median_km_s=medians, fits=nfits, failed_fits=failed,
        fit_ms_card=1e3 * fit_s / nfits, fit_ms_cpu=1e3 * cpu_s / nfits,
        max_abs_err_card_vs_cpu=errs,
        launches={k: v for k, v in launches.items() if v})
    log('(j) post-processing of (d): ' + json.dumps(stats))
    if not all(errs[k] <= PUBLIC_TOLS[k] for k in errs):
        raise AssertionError('the data fits on the card miss the CPU fits')
    if not all(launches[k] for k in ('K4', 'K6', 'K3')):
        raise AssertionError('the data fits missed a kernel: %s'
                             % json.dumps(launches))
    return launches


def single_chain(torch):
    """(j-2): ``SingleChain`` on the tutorial's targets and priors
    (``SINGLE_ITERS``, ``SINGLE_MAXMODELS``, ``SINGLE_SEED``) on the
    card, twice from the seed, each with the launch counts set to 0
    before: the reference layout's shapes, finite likes, K4, K6 and K3
    at its cold init and K1, K2 and K3 in its steps, and equal arrays in
    both runs.  Returns (launches at init, launches in all) of the
    first."""
    from bayhunter_tpu_torch import SingleChain, bench_config
    targets, _ = bench_config.tutorial_targets()
    priors, ip = bench_config.tutorial_params()
    ip.update(iter_burnin=SINGLE_ITERS[0], iter_main=SINGLE_ITERS[1],
              maxmodels=SINGLE_MAXMODELS)
    names = ('models', 'likes', 'misfits', 'noise', 'vpvs')
    runs = []
    for _ in range(2):
        reset_counts()
        sc = SingleChain(targets, initparams=ip, modelpriors=priors,
                         random_seed=SINGLE_SEED)
        at_init = counted_init(sc.sampler)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.run_chain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append((sc, at_init, launch_counts(), wall))
    (sc, at_init, counts, wall), again = runs[0], runs[1][0]
    nl = int(priors['layers'][1]) + 1
    shapes = {}
    for phase, niter in zip(('p1', 'p2'), SINGLE_ITERS):
        S = niter // int(np.ceil(niter / SINGLE_MAXMODELS))
        want = dict(models=(S, 2 * nl), likes=(S,), misfits=(S, 3),
                    noise=(S, 4), vpvs=(S,))
        for k in names:
            a = getattr(sc, phase + k)
            shapes[phase + k] = list(a.shape)
            if a.shape != want[k] or a.dtype != np.float32:
                raise AssertionError('SingleChain %s%s: %s %s' % (
                    phase, k, a.dtype, a.shape))
            if not np.array_equal(a, getattr(again, phase + k),
                                  equal_nan=True):
                raise AssertionError('SingleChain %s%s differs in a run '
                                     'from the same seed' % (phase, k))
        if not np.isfinite(getattr(sc, phase + 'likes')).all():
            raise AssertionError('SingleChain %slikes not finite' % phase)
    steps = {k: counts[k] - at_init[k] for k in counts}
    stats = dict(iterations=sum(SINGLE_ITERS), wall_s=[r[3] for r in runs],
                 ms_per_iteration=[1e3 * r[3] / sum(SINGLE_ITERS)
                                   for r in runs],
                 shapes=shapes, final_logL=float(sc.final_state.logL[0]),
                 p2likes_median=float(np.median(sc.p2likes)),
                 launches_init={k: v for k, v in at_init.items() if v},
                 launches_steps={k: v for k, v in steps.items() if v})
    log('(j) SingleChain: ' + json.dumps(stats))
    if not (all(at_init[k] for k in ('K4', 'K6', 'K3'))
            and all(steps[k] for k in ('K1', 'K2_rayleigh', 'K3'))):
        raise AssertionError('SingleChain missed a kernel')
    return at_init, counts


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


def counted_cold(ev):
    """The launch counts of the evaluator ``ev``'s cold evaluations
    (``eval_cold``, wrapped here), summed over its calls from now on."""
    cold = dict.fromkeys(launch_counts(), 0)
    inner = ev.eval_cold

    def counted(*a, **kw):
        before = launch_counts()
        out = inner(*a, **kw)
        for k, v in launch_counts().items():
            cold[k] += v - before[k]
        return out

    ev.eval_cold = counted
    return cold


def cold_searches(counts):
    """Launch counts with K4 and K5 alone: a cold search's launches
    outside a sampler's cold init (the walker's cold roots, SynthObs)."""
    return {k: (v if k in ('K4', 'K5') else 0) for k, v in counts.items()}


def same_as_fixtures(path):
    """Max difference, in units of the files' fourth decimal, of each
    ``st3_*.dat`` in ``path`` from the golden fixture, after checking
    that every file is there with the fixtures' x and the model file
    equals the fixture's."""
    fixtures = os.path.join(ROOT, 'tests', 'fixtures')
    if sorted(os.listdir(path)) != sorted(
            ['st3_%s.dat' % r for r in PUBLIC_TOLS] + ['st3_mod.dat']):
        raise AssertionError('(l-5): files %s' % sorted(os.listdir(path)))
    units = {}
    for ref in PUBLIC_TOLS:
        got, want = (np.loadtxt(os.path.join(d, 'st3_%s.dat' % ref))
                     for d in (path, fixtures))
        if got.shape != want.shape or not np.array_equal(got[:, 0],
                                                         want[:, 0]):
            raise AssertionError('(l-5): st3_%s.dat x' % ref)
        units[ref] = int(np.rint(np.abs(got[:, 1] - want[:, 1])
                                 * 1e4).max())
    got, want = (np.loadtxt(os.path.join(d, 'st3_mod.dat'), skiprows=1)
                 for d in (path, fixtures))
    if not np.array_equal(got, want):
        raise AssertionError('(l-5): st3_mod.dat differs')
    return units


def gates_and_tutorial(torch, dev, tmp, by_path):
    """(l): the JAX package's sampler gates (``gates.py``) on the card
    with the kernels, then the tutorial scripts' counterparts, each step
    with the launch counts set to 0 before and read after, its wall
    seconds logged: (l-1) the dimension-reject pin at 128 chains
    (asserted) and at ``GATE_WIDE`` (measured), (l-2) the converged
    band, (l-3) the warm walker (K2) against the port's float64 cold
    solve on the CPU, (l-4) the prior-only layer histogram at the
    tutorial's priors and ``PRIOR_GATE_CHAINS``, (l-5)
    ``create_testdata_torch`` against the fixtures, (l-6)
    ``tutorialhunt_torch.main`` without figures: the ``.npy`` contract
    and the final posterior arrays.  Adds each step to ``by_path``."""
    from bayhunter_tpu_torch import bench_config, gates
    sys.path.insert(0, os.path.join(ROOT, 'tutorial'))
    import create_testdata_torch
    import tutorialhunt_torch
    t_l = time.perf_counter()

    def step(name, required, fn, n_rf=1):
        reset_counts()
        t = time.perf_counter()
        result, cold = fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        result['seconds'] = time.perf_counter() - t
        result['launches'] = {k: v for k, v in counts.items() if v}
        log('(%s): %s' % (name, json.dumps(result)))
        missing = [k for k in required if counts[k] == 0]
        if missing:
            raise AssertionError('(%s): kernels %s never launched'
                                 % (name, missing))
        by_path[name] = ((cold_searches(counts) if cold is None else cold),
                         counts, n_rf)
        return result

    def pin():
        sp = gates.pin_sampler(dev)
        cold = counted_cold(sp.ev)
        out = dict(pin=gates.check('pin', gates.dim_reject_pin(sp)),
                   wide=gates.dim_reject_pin(sp, GATE_WIDE))
        return out, cold

    def converged():
        sp = gates.pin_sampler(dev)
        cold = counted_cold(sp.ev)
        return gates.check('converged', gates.converged_band(sp)), cold

    def walker():
        return gates.check('walker', gates.walker_golden(dev)), None

    def prior():
        priors = bench_config.tutorial_params()[0]
        sp = gates.prior_sampler(priors, dev, ('swd', 'rf'))
        cold = counted_cold(sp.ev)
        out = gates.check('prior', gates.prior_histogram(
            sp, PRIOR_GATE_CHAINS, segments=PRIOR_GATE_SEGMENTS))
        if not out['se_ok']:
            raise AssertionError('(l-4): standard errors %r' % out)
        return out, cold

    observed = os.path.join(tmp, 'l5')

    def testdata():
        create_testdata_torch.main(observed, device=dev)
        units = same_as_fixtures(observed)
        bad = [r for r, u in units.items()
               if u > round(PUBLIC_TOLS[r] * 1e4)]
        if bad:
            raise AssertionError('(l-5): %s miss the fixtures: %r'
                                 % (bad, units))
        return dict(units_of_1e4=units), None

    def hunt():
        from bayhunter_tpu_torch import MCMC_Optimizer

        class Counted(MCMC_Optimizer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                Counted.at_init = counted_init(self.sampler)

        tutorialhunt_torch.MCMC_Optimizer = Counted
        t = time.perf_counter()
        try:
            opt, _ = tutorialhunt_torch.main(
                os.path.join(tmp, 'l6'), nchains=HUNT_CHAINS,
                iter_burnin=HUNT_ITERS[0], iter_main=HUNT_ITERS[1],
                random_seed=HUNT_SEED, device=dev, plots=False,
                observed=observed)
        finally:
            tutorialhunt_torch.MCMC_Optimizer = MCMC_Optimizer
        wall = time.perf_counter() - t      # data, inversion, posterior
        plans = check_contract(opt, final_files(opt.savepath))
        models = np.load(os.path.join(opt.savepath, 'c_models.npy'))
        if not len(models) or models.shape[1:] != (2 * opt.maxlayers,):
            raise AssertionError('(l-6): c_models.npy %s' % (models.shape,))
        return dict(snapshots=plans, final_models=len(models),
                    **optimizer_stats(opt, wall)), Counted.at_init

    warm = ('K1', 'K2_rayleigh', 'K3', 'K4', 'K6')
    out = dict(pin=step('l-1', warm, pin),
               converged=step('l-2', warm, converged),
               walker=step('l-3', ('K2_rayleigh', 'K4'), walker),
               prior=step('l-4', ('K1',), prior),
               testdata=step('l-5', ('K3', 'K3_sv', 'K4', 'K5', 'K6'),
                             testdata, n_rf=0),
               tutorialhunt=step('l-6', warm, hunt))
    log('(l) took %.1f s' % (time.perf_counter() - t_l))
    return out



# ----------------------------------------------------------------------
# (m): the per-chain ring path and the float64 instances
# ----------------------------------------------------------------------

def ring_kernels(torch, dev):
    """(m-1): K4, K5, K6 and K3 in float64 against their twins run in
    float64 on the card, bit for bit, at 10,240 grown chains and the ring
    path's shapes: K4/K5 on the ring's first trip at ring 16 (the
    previous roots and 16 points each side, (C, 21, 33)) around the
    grown models' float64 cold roots, K6 on their layer planes, K3 at
    all 257 lanes on K6's operands.  Returns their records (bound by
    float64 operations over ``PEAK_FLOPS_F64``)."""
    from bayhunter_tpu_torch.ops import prep, resp, rf, swd, voronoi
    f64 = torch.float64
    VS, Z, N = grown_models(C_MAIN, NL)
    layers = voronoi.voronoi_to_layers(
        torch.tensor(VS, device=dev, dtype=f64),
        torch.tensor(Z, device=dev, dtype=f64), torch.tensor(N, device=dev),
        torch.full((C_MAIN,), 1.73, dtype=f64, device=dev))
    periods = np.loadtxt(os.path.join(ROOT, 'tests', 'fixtures',
                                      'st3_rdispph.dat'))[:, 0]
    _, err, roots, _ = swd.surfdisp_roots_cold(*layers, periods)
    log('(m-1) the grown models\' float64 cold roots: %d of %d chains '
        'solved at every period' % (int((~err).sum()), C_MAIN))
    R, K = roots.shape[1], RING_CHECK_HALFWIDTH
    omega = swd.angular_frequencies(periods, dev, f64)[None, :, None]
    steps = torch.arange(1, K + 1, dtype=f64, device=dev) * swd.DDC
    c = torch.cat([roots[..., None], roots[..., None] + steps,
                   roots[..., None] - steps], dim=-1)
    top = swd.layer_top(layers[0])
    out = []
    for iwave, counter, twin in ((2, 'K4_f64', swd.dltar4),
                                 (1, 'K5_f64', swd.dltar1)):
        args = layers if iwave == 2 else (layers[0], layers[2], layers[3])
        call = secular_call(layers, c, omega, iwave)
        tag = '%s %s secular values, float64, ring 16 trip 0 (%dx%dx%d)' % (
            counter[:2], 'Rayleigh' if iwave == 2 else 'Love', C_MAIN, R,
            2 * K + 1)
        kv = call()
        err_k = check_bitwise(torch, tag, (kv,),
                              (twin(omega / c, omega, *args),))
        out.append(entry(
            counter, tag, 'secular.cu',
            'pallas_secular.py:%d' % (267 if iwave == 2 else 332), err_k,
            timed(call, KERNEL_REPS),
            timed(lambda: twin(omega / c, omega, *args), 3),
            nbytes(c, kv, *args) + 8 * R,
            secular_ops(top, R * (2 * K + 1), iwave), peak=PEAK_FLOPS_F64))
    planes = tuple(x.T.contiguous() for x in layers)
    p_skm = 6.4 * rf.DEG_PER_KM
    coefs, pack = prep.rf_operands(*planes, p_skm)
    err6 = check_bitwise(torch, 'K6 RF operands, float64 (P)',
                         (coefs, pack),
                         prep.rf_operands_plain(*planes, p_skm))
    out.append(entry(
        'K6_f64', 'K6 RF operands, float64', 'prep.cu', 'pallas_prep.py:141',
        err6, timed(lambda: prep.rf_operands(*planes, p_skm), KERNEL_REPS),
        timed(lambda: prep.rf_operands_plain(*planes, p_skm), 3),
        nbytes(*planes, coefs, pack),
        C_MAIN * (OPS['rf_fixed'] + NL * (OPS['rf_flatten_slot']
                                          + OPS['rf_t0_slot'])
                  + (NL - 1) * OPS['rf_interface']), peak=PEAK_FLOPS_F64))
    F = 257
    rargs = (coefs, pack, F, 512, 5.0, rf.P_WAVE)
    err3 = check_bitwise(torch, 'K3 RF response, float64 (%d lanes)' % F,
                         resp.resp(*rargs), resp.resp_plain(*rargs))
    depth = pack[rf.pack_offsets(NL)['depth']].clamp(max=NL - 2).double()
    out.append(entry(
        'K3_f64', 'K3 RF response, float64 (%d lanes)' % F, 'resp.cu',
        'pallas_rf.py:288', err3, timed(lambda: resp.resp(*rargs),
                                        KERNEL_REPS),
        timed(lambda: resp.resp_plain(*rargs), 3),
        nbytes(pack, *resp.resp(*rargs))
        + 8 * 32 * C_MAIN * float((depth + 1).mean()),
        resp_ops(F, depth, False, 0), peak=PEAK_FLOPS_F64))
    log('(m-1) geometries: K4 %s, K5 %s, K6 %s, K3 %s' % (
        swd.geometry(C_MAIN, R, 2 * K + 1, NL, 2, 8),
        swd.geometry(C_MAIN, R, 2 * K + 1, NL, 1, 8),
        prep.geometry(C_MAIN, NL, 1, False, elem=8),
        resp.geometry(C_MAIN, F, NL, elem=8)))
    return out


def ring_main_path(torch, dev, dtype):
    """(m-2): ``tutorial`` through ``build_evaluator(...,
    use_batch_swd=False)`` at 10,240 chains and ``dtype``: its cold
    init, the early cycles and ``RING_LATE_ITERS`` timed late iterations,
    the launch counts set to 0 before and read after; logs the rate, the
    forward rejects (the dimension moves' expected near 0), the launches
    and the ring trips of the dimension steps.  Fails unless K4, K6 and
    K3 at ``dtype`` launched and K1 and K2 did not.  Returns (launches at
    init, launches in all)."""
    from bayhunter_tpu_torch import bench_config
    from bayhunter_tpu_torch.ops import swd
    from bayhunter_tpu_torch.sampler.chain import (MOVE_DIM, cycle_moves,
                                                   dispatch_cycles)
    name = 'ring_path_%s' % str(dtype).split('.')[-1]
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    sampler, ev = bench_config.build_config('tutorial', dev, ITERS, NL,
                                            dtype, use_batch_swd=False)
    t0 = time.perf_counter()
    states, gen = sampler.init_states_host(0, C_MAIN)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    at_init = launch_counts()
    it = -ITERS
    cel = len(sampler.early_order)
    n_early = int(np.ceil(max(0.0, sampler.early_cutoff - it) / cel)) * cel
    t0 = time.perf_counter()
    states = dispatch_cycles(sampler, states, it, n_early, gen)
    it += n_early
    clen = len(sampler.late_order)
    states = dispatch_cycles(sampler, states, it, 2 * clen, gen)   # warm
    it += 2 * clen
    torch.cuda.synchronize()
    t_early = time.perf_counter() - t0
    ff0, pp0 = (x.sum(0).cpu().numpy() for x in (states.fwdfail,
                                                states.proposed))
    dim_trips = dim_calls = 0
    t0 = time.perf_counter()
    for move in cycle_moves(sampler, it, RING_LATE_ITERS, gen):
        calls, trips = swd.ring_brackets.calls, swd.ring_brackets.trips
        states = sampler.advance(states, move, gen)
        if move == MOVE_DIM:
            dim_calls += swd.ring_brackets.calls - calls
            dim_trips += swd.ring_brackets.trips - trips
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    ff, pp = (x.sum(0).cpu().numpy() - y for x, y in (
        (states.fwdfail, ff0), (states.proposed, pp0)))
    stats = dict(
        config=name, init_s=t_init, early_s=t_early,
        proposals_per_s=RING_LATE_ITERS * C_MAIN / dt,
        iters_timed=RING_LATE_ITERS, seconds_timed=dt,
        fwd_reject_pct=100.0 * ff.sum() / max(pp.sum(), 1),
        fwd_reject_dim_pct=(100.0 * ff[2] / pp[2]) if pp[2] else None,
        dim_ring_solves=dim_calls, dim_ring_trips=dim_trips,
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        launches={k: v for k, v in launches.items() if v})
    log('(m-2) ring path: ' + json.dumps(stats))
    suffix = '_f64' if dtype == torch.float64 else ''
    missing = [k for k in ('K4', 'K6', 'K3') if launches[k + suffix] == 0]
    stray = [k for k in ('K1', 'K2_rayleigh') if launches[k]]
    if missing or stray:
        raise AssertionError('%s: kernels %s never launched, %s launched'
                             % (name, missing, stray))
    if dtype == torch.float64 and any(launches[k] for k in ('K3', 'K4',
                                                             'K6')):
        raise AssertionError('%s: a float32 kernel launched' % name)
    if not (bool(torch.isfinite(states.logL).all())
            and states.logL.dtype == dtype
            and stats['fwd_reject_dim_pct'] is not None
            and stats['fwd_reject_dim_pct'] < RING_DIM_REJECT_PCT):
        raise AssertionError('%s: logL %s, dimension rejects %s %%'
                             % (name, states.logL.dtype,
                                stats['fwd_reject_dim_pct']))
    RATES[name] = stats['proposals_per_s']
    return at_init, launches


def optimizer_float64(torch, tmp):
    """(m-3): ``MCMC_Optimizer(dtype=torch.float64)`` on the tutorial's
    configuration at ``F64_CHAINS`` chains, ``F64_ITERS``, with the
    ``.npy`` contract (float32 files)."""
    from bayhunter_tpu_torch import bench_config
    targets, _ = bench_config.tutorial_targets()
    priors, ip = bench_config.tutorial_params()
    ip.update(nchains=F64_CHAINS, iter_burnin=F64_ITERS[0],
              iter_main=F64_ITERS[1], maxmodels=64,
              savepath=os.path.join(tmp, 'm3'))
    opt, wall, at_init, counts = run_optimizer(
        torch, targets, priors, ip, OPT_SEED, dtype=torch.float64)
    if opt.eval_fn.batch or opt.final_states.logL.dtype != torch.float64:
        raise AssertionError('(m-3) ran the batch path or float32')
    stats = optimizer_stats(opt, wall)
    stats.update(snapshots=check_contract(opt),
                 launches={k: v for k, v in counts.items() if v})
    log('optimizer (m-3), float64: ' + json.dumps(stats))
    if any(counts[k] for k in ('K1', 'K2_rayleigh', 'K3', 'K4', 'K6')):
        raise AssertionError('(m-3) launched a float32 kernel')
    return at_init, counts


def ring_path(torch, dev, tmp, by_path):
    """(m): the float64 kernels (m-1), the ring path at float32 and
    float64 (m-2), a float64 optimizer run (m-3); each path's launches
    in ``by_path``.  Returns the float64 kernels' records."""
    t_m = time.perf_counter()
    kernels = ring_kernels(torch, dev)
    for dtype in (torch.float32, torch.float64):
        at_init, counts = ring_main_path(torch, dev, dtype)
        by_path['ring_path_' + str(dtype).split('.')[-1]] = (at_init,
                                                             counts, 1)
    at_init, counts = optimizer_float64(torch, tmp)
    by_path['optimizer_float64'] = (at_init, counts, 1)
    log('(m) took %.1f s' % (time.perf_counter() - t_m))
    return kernels


def profile_steps(torch, sampler, states, gen, config='tutorial'):
    """Where the late steps' time goes in configuration ``config``:
    host-clock ms per step of each move (draws included,
    synchronised), then ``PROFILE_CYCLES`` late cycles under
    torch.profiler — wall time, the device's busy time (union of its
    kernel and copy intervals) and idle share, and each kernel's device
    time."""
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
        config=config, step_ms=step_ms, profiled_iters=iters,
        wall_ms=wall_ms,
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
    for name in ('tutorial', 'tutorial_rl_prf', 'tutorial_prf_srf',
                 'tutorial_six', 'tutorial_six_sph'):
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

    t_start = time.perf_counter()
    def phase(name):
        log('phase %s done at %.1f s' % (name, time.perf_counter() - t_start))

    kernels = check_kernels(torch, dev)
    phase('kernels')
    check_ragged(torch, dev)
    phase('ragged')
    check_golden(torch, dev)
    phase('golden')
    # (f): the public forward (K4, K5, K6, K3 as a warm K3 at the
    # Gauss-cut lanes; no cold init)
    by_path = {'public_forward': (dict.fromkeys(launch_counts(), 0),
                                  check_public_forward(torch, dev), 0)}
    phase('public forward')
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
    # (g) the six target kinds, flat and spherical
    six = ('K1', 'K2_rayleigh', 'K2_group_R', 'K2_group_L', 'K3', 'K3_sv',
           'K4', 'K5', 'K6')
    for name, build, kernels_six in (
            ('tutorial_six', bench_config.build_six,
             six + ('K2_love',)),
            ('tutorial_six_sph', bench_config.build_six_sph,
             six + ('K1_sph', 'K2_sph_L'))):
        init_s, all_s, n_rf, sampler, states, gen = main_path(
            torch, dev, name, build, kernels_six, SIX_LATE_CYCLES)
        by_path[name] = (init_s, all_s, n_rf)
        phase(name)
        if name == 'tutorial_six':
            six_run = (sampler, states, gen)
        del sampler, states, gen
    profile_steps(torch, *six_run, config='tutorial_six')
    del six_run
    # the inversion as users run it: (b), (c), (d)
    tmp = tempfile.mkdtemp(prefix='bh_chip_smoke_')
    try:
        for name, run, mantle in (
                ('optimizer_tutorial', optimizer_tutorial, False),
                ('optimizer_defaults', optimizer_defaults, True),
                ('tutorial_21_chains', optimizer_recovery, False)):
            stats_o, init_o, all_o = run(torch, tmp)
            phase(name)
            missing = [k for k in ('K1', 'K2_rayleigh', 'K3', 'K4', 'K6')
                       if all_o[k] == 0]
            if missing:
                raise AssertionError('%s: kernels %s never launched'
                                     % (name, missing))
            by_path[name] = (init_o, all_o, 1, mantle)
        kept_d = stats_o['kept']     # (d)'s chains, for (j)
        # (h): the receiver-function forms and a custom target
        t_h = time.perf_counter()
        kernels += check_rf_forms(torch, dev)
        by_path['rf_forms'] = (zero, rf_forms_path(torch, dev), 0)
        _, init_h, all_h = optimizer_custom(torch, tmp)
        by_path['custom_target'] = (init_h, all_h, 1)
        log('(h) took %.1f s' % (time.perf_counter() - t_h))
        phase('rf forms and custom targets')
        # (i): the ensemble extensions; the tomography's K1 launches,
        # which take the dispersion set alone, count with the K1 record
        t_i = time.perf_counter()
        _, init_i, all_i = optimizer_tempered(torch, tmp)
        by_path['tempered_tutorial'] = (init_i, all_i, 1)
        phase('tempered tutorial')
        tomo_ref, init_t, all_t = tomo_run(torch, dev)
        by_path['tomo_1000x100'] = (init_t, all_t, 1)
        log('(i) took %.1f s' % (time.perf_counter() - t_i))
        phase('tomography')
        # (j): the post-processing of (d)'s files and the single-chain
        # front end, without matplotlib or zmq
        t_j = time.perf_counter()
        by_path['postprocess'] = (zero, postprocess(
            torch, os.path.join(tmp, 'd%d' % TUTORIAL_SEED, 'data'),
            kept_d), 0)
        phase('post-processing')
        init_j, all_j = single_chain(torch)
        by_path['single_chain'] = (init_j, all_j, 1)
        for mod in ('matplotlib', 'zmq'):
            if mod in sys.modules:
                raise AssertionError('(j) imported %s' % mod)
        log('(j) took %.1f s' % (time.perf_counter() - t_j))
        phase('single chain')
        # (k): the split over two workers, on one card or two
        t_k = time.perf_counter()
        devs = split_devices(torch)
        _, init_k, all_k = split_tomo(torch, devs, tomo_ref)
        by_path['split_tomo'] = (init_k, all_k, 1)
        del tomo_ref
        _, init_k, all_k, one_card = split_optimizer(torch, devs, tmp)
        by_path['split_optimizer'] = (init_k, all_k, 1)
        by_path['split_references'] = one_card + (1,)
        split_step_cost(torch, dev)
        log('(k) took %.1f s' % (time.perf_counter() - t_k))
        phase('split')
        # (l): the sampler gates and the tutorial scripts
        gates_and_tutorial(torch, dev, tmp, by_path)
        phase('gates and tutorial')
        # (m): the per-chain ring path and the float64 kernels
        kernels += ring_path(torch, dev, tmp, by_path)
        phase('ring path')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # each record's launches on the paths: K1 by its number of RF
    # operand sets and its arm; K3 at all frequencies in the cold inits,
    # the others (the public forward's and synrf's all-lane launches
    # among them) with the warm records; the options arms and K6's
    # unflattened arm apart from the default arms
    rules = dict(
        K1=lambda i, t, n, m=False: (t['K1'] - t['K1_layers']
                                     if n == 1 and not m else 0),
        K1_mantle=lambda i, t, n, m=False: t['K1'] if m else 0,
        K1_2rf=lambda i, t, n, m=False: (t['K1'] - t['K1_sph']
                                         if n == 2 else 0),
        K3_warm=lambda i, t, n, m=False: (
            t['K3'] - t['K3_sv'] - t['K3_optP'])
        - (i['K3'] - i['K3_sv'] - i['K3_optP']),
        K3_cold=lambda i, t, n, m=False: i['K3'] - i['K3_sv']
        - i['K3_optP'],
        K3_sv=lambda i, t, n, m=False: (t['K3_sv'] - t['K3_optSV'])
        - (i['K3_sv'] - i['K3_optSV']),
        K3r_p=lambda i, t, n, m=False: t['K3r'] - t['K3r_sv']
        - t['K3r_optP'],
        K3r_sv=lambda i, t, n, m=False: t['K3r_sv'] - t['K3r_optSV'],
        K4_cold=lambda i, t, n, m=False: i['K4'],
        K5_cold=lambda i, t, n, m=False: i['K5'],
        K6=lambda i, t, n, m=False: t['K6'] - t['K6_unflat'],
        K6_cold=lambda i, t, n, m=False: i['K6'])
    phase('main paths')
    profile_kernels(torch, dev, kernels)
    profile_cold_inits(torch, dev)
    phase('profiles')
    for k in kernels:
        counter = k.pop('counter')
        rule = rules.get(counter, lambda i, t, n, m=False: t[counter])
        per = {path: rule(*counts) for path, counts in by_path.items()}
        k['launches'] = sum(per.values())
        k['launches_by_path'] = per
    log('chip_smoke.py: %.1f s after the build' % (time.perf_counter()
                                                   - t_start))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
