"""Build and ctypes binding of the CUDA kernels in ``csrc/``.

The kernels are compiled with ``nvcc`` into one shared library with a
plain C interface at their first launch, into
``build/bayhunter_tpu_torch/`` under the repository root: one ``nvcc``
process per source, all started together, then one link.  The
library name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing library.
Nothing here runs at import time: importing this module needs no CUDA
toolchain.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build',
                         'bayhunter_tpu_torch')

# --fmad=false keeps a*b+c unfused so the kernels round like their
# plain twins: the walker's sign decisions and the RF branch cuts
# depend on the last ulps (and --use_fast_math is never used)
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '--fmad=false', '-Xptxas=-v']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class PackLayout(ctypes.Structure):
    """``struct PackLayout`` of ``csrc/pack.cuh``: the RF pack's row
    offsets, passed by value to K1, K3 and K6 (see
    ``rf.pack_offsets``)."""
    _fields_ = [(name, _I) for name in ('h', 'vp', 'vs', 'p', 't0', 'hmat',
                                        'nt', 'depth', 'rows')]


RF_MAX = 4      # RF targets K1 serves (csrc/prep.cu RF_MAX)


class RfSpecs(ctypes.Structure):
    """``struct RfSpecs`` of ``csrc/prep.cu``: K1's RF targets, each a
    slowness, a wave type and the rows of K1's output buffer at which
    its (coefs, pack) planes start."""
    _fields_ = [('n', _I), ('p', _F * RF_MAX), ('wave', _I * RF_MAX),
                ('coefs', _I * RF_MAX), ('pack', _I * RF_MAX)]


class PriorCfg(ctypes.Structure):
    """``struct PriorCfg`` of ``csrc/prep.cu``: the prior bounds K1
    checks."""
    _fields_ = [('layermin', _I), ('layermax', _I)] + [
        (name, _F) for name in ('vsmin', 'vsmax', 'zmin', 'zmax', 'thickmin',
                                'lvz_factor', 'hvz_factor')] + [
        ('use_lvz', _I), ('use_hvz', _I)]


SIGNATURES = {
    # K1: vs_t, z_t, n, vpvs | nl, C | priors, rf specs, layout |
    # threads, tile, smem (prep.geometry) | valid, out | stream
    'bh_prep': [_P, _P, _P, _P, _I, _I, PriorCfg, RfSpecs, PackLayout, _I,
                _I, _I, _P, _P, _P],
    # K2: props, omegas, c_prev, cm, bx, top, slope_prev | nl, C, R,
    # max_steps, nbisect, newton_iters, newton_maxshift, has_slope,
    # iwave | threads, tile, smem (walk.geometry) | c, found, slope |
    # stream
    'bh_walk': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # K3: coefs, pack, layout | nl, C, F, nsamp, wave | dw | threads,
    # tile, cs, smem (resp.geometry) | czr, czi, crr, cri | stream
    'bh_resp': [_P, _P, PackLayout, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                _P, _P, _P, _P, _P],
    # K3r: coefs, pack, qp, qs, layout | nl, C, F, nsamp, wave | dw,
    # wref | threads, tile, cs, smem | czr, czi, crr, cri | stream
    'bh_resp_q': [_P, _P, _P, _P, PackLayout, _I, _I, _I, _I, _I, _F, _F,
                  _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # K4: c and its strides over (C, R, K), omega and its strides over
    # (C, R), d, a, b, rho | nl, C, R, K | threads, tile, smem
    # (swd.geometry) | out | stream
    'bh_secular4': [_P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                    _I, _I, _I, _I, _P, _P],
    # K5: as K4 without a
    'bh_secular1': [_P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                    _I, _I, _I, _P, _P],
    # K4 (iwave 2) or K5 (1): iwave, threads, smem | blocks per SM
    'bh_secular_occupancy': [_I, _I, _I, _P],
    # K6: h, vp, vs, rho | nl, C | p, wave, layout | threads, tile,
    # smem (prep.geometry) | out | stream
    'bh_rf_prep': [_P, _P, _P, _P, _I, _I, _F, _I, PackLayout, _I, _I, _I,
                   _P, _P],
}

_lock = threading.Lock()


class _Build:
    lib = None
    seconds = None
    log = ''


def nvcc_path():
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(home, 'bin', 'nvcc')
    return cand if os.path.exists(cand) else shutil.which('nvcc')


def sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, '*.cu'))
                  + glob.glob(os.path.join(SRC_DIR, '*.cuh')))


def library_path(flags=NVCC_FLAGS):
    h = hashlib.sha256(' '.join(flags).encode())
    for path in sources():
        with open(path, 'rb') as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, 'libbh_kernels_%s.so'
                        % h.hexdigest()[:16])


def load():
    """The loaded kernel library, built on first use."""
    with _lock:
        if _Build.lib is None:
            _Build.lib = _build_and_load()
    return _Build.lib


def _build_and_load(flags=NVCC_FLAGS):
    """The library built with nvcc ``flags`` (the shipped ones unless a
    measurement asks for others), loaded with its signatures."""
    out = library_path(flags)
    t0 = time.perf_counter()
    if os.path.exists(out + '.log'):
        with open(out + '.log') as f:
            _Build.log = f.read()
    if not os.path.exists(out):
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError('nvcc not found: the CUDA kernels of '
                               'bayhunter_tpu_torch need the CUDA '
                               'toolkit (set CUDA_HOME)')
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = '%s.%d' % (out, os.getpid())
        cu = [s for s in sources() if s.endswith('.cu')]
        objs = ['%s.%s.o' % (tmp, os.path.basename(s)[:-3]) for s in cu]
        procs = [subprocess.Popen([nvcc] + flags + ['-I', SRC_DIR, '-c',
                                                   '-o', o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        _Build.log = ''.join(logs)
        failed = [s for s, p in zip(cu, procs) if p.returncode != 0]
        if not failed:
            r = subprocess.run([nvcc, '-shared', '-o', tmp + '.so'] + objs,
                               capture_output=True, text=True)
            _Build.log += r.stdout + r.stderr
            if r.returncode != 0:
                failed = ['link']
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        if failed:
            raise RuntimeError('nvcc failed (%s):\n%s'
                               % (', '.join(map(os.path.basename, failed)),
                                  _Build.log[-6000:]))
        with open(out + '.log', 'w') as f:
            f.write(_Build.log)
        os.replace(tmp + '.so', out)
    lib = ctypes.CDLL(out)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.bh_error_string.argtypes = [ctypes.c_int]
    lib.bh_error_string.restype = ctypes.c_char_p
    _Build.seconds = time.perf_counter() - t0
    return lib


def build_info():
    """(seconds the last build-and-load took, nvcc's output when it
    built the library, which is kept beside it)."""
    return _Build.seconds, _Build.log


def check(rc, name):
    if rc != 0:
        msg = _Build.lib.bh_error_string(rc).decode()
        raise RuntimeError('%s kernel launch failed: CUDA error %d (%s)'
                           % (name, rc, msg))


def pack_layout(offsets):
    """The :class:`PackLayout` of an ``rf.pack_offsets`` dict."""
    return PackLayout(**offsets)


def ptr(t):
    """A tensor's device address for a ``c_void_p`` argument (None for
    an absent tensor): ctypes converts a plain int or None itself, which
    costs less host time than a ``c_void_p`` object per pointer."""
    return t.data_ptr() if t is not None else None


def stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def require(t, name, device, dtype, shape, contiguous=True):
    """Raise unless ``t`` is a ``dtype`` tensor of ``shape`` on
    ``device``, a CUDA device, and contiguous unless the kernel takes
    its strides (``contiguous=False``)."""
    if device.type != 'cuda':
        raise ValueError('%s is on %s: the kernels take CUDA tensors'
                         % (name, device))
    if t.device != device:
        raise ValueError('%s is on %s, expected %s' % (name, t.device,
                                                       device))
    if t.dtype != dtype:
        raise TypeError('%s has dtype %s, expected %s' % (name, t.dtype,
                                                          dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError('%s has shape %s, expected %s'
                         % (name, tuple(t.shape), tuple(shape)))
    if contiguous and not t.is_contiguous():
        raise ValueError('%s must be contiguous' % name)
