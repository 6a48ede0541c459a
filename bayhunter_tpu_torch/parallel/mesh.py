"""The chain axis split over several devices: the counterpart of
``bayhunter_tpu/parallel/mesh.py``.

Chains are independent, so the split needs no collective.  Each entry
of ``devices`` gets one worker process, started from the ``spawn``
context (never forked: a forked child cannot use CUDA once its parent
has), that owns a contiguous row block of the batch and runs the
sampler on its device.  A block holds whole temperature groups (``group``
rows, rung fastest), so that a replica-exchange sweep never pairs rows
of two workers, and so no block is padded; entries may repeat (two
workers on one GPU, or ``['cpu'] * 8``).  No ``torch.distributed``, no
NCCL and no CUDA IPC: the parent sends host-side inputs (numpy arrays,
the targets pickled) and each worker builds its evaluator and sampler
on its own device.  A worker draws every random tensor at the full
width of the batch from a generator seeded as the one-device run's and
keeps its rows (``sampler.chain.Rows``), and its evaluator runs the
products whose rounding of a row depends on the batch's shape at the
one-device width (``Evaluator._wide``), so an n-worker run is the
one-device run chain by chain, bit for bit, as long as no resort moves
chains between rows (a resort sorts within each block, as the JAX
package's ``resort_states(mesh=...)`` sorts within each shard).  That
holds for the built-in SWD and RF targets; a custom target's forward
runs on the block as it is, and keeps it only if its rounding of a
chain does not depend on the batch's shape.

:class:`Workers` is the pool: it sends a command to every worker,
waits for every answer, raises a worker's exception in the parent with
the worker's traceback, raises when a worker exits without an answer
or gives none within ``timeout`` seconds, and joins every worker when
it closes.  ``MCMC_Optimizer`` and ``TomoInversion`` drive it through
``devices=``.
"""

import multiprocessing.connection
import time
import traceback

import numpy as np
import torch

from bayhunter_tpu_torch.sampler.chain import ChainState, Rows
from bayhunter_tpu_torch.utils import resolve_device

WORKER_TIMEOUT = 3600.0     # seconds a command may take in a worker


def context():
    """The start context of every worker: ``spawn``, whatever the
    platform's default."""
    return torch.multiprocessing.get_context('spawn')


def visible_devices():
    """Every visible CUDA device: the default of ``devices``."""
    return [torch.device('cuda', i)
            for i in range(torch.cuda.device_count())]


def resolve_devices(device, devices, who):
    """``(device, devices)`` of an entry point that takes both: a split
    run gives ``(the host's CPU, [torch.device, ...])`` for two entries
    or more, a run in this process ``(its device, None)``.  ``device``
    keeps its meaning; ``devices=None`` with ``device=None`` is every
    visible CUDA device, so one GPU runs in this process as before and
    none raises (``utils.resolve_device``)."""
    if device is not None and devices is not None:
        raise ValueError('%s takes device or devices, not both' % who)
    if devices is None:
        if device is not None:
            return resolve_device(device, who), None
        devices = visible_devices()
        if len(devices) < 2:
            return resolve_device(None, who), None
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError('%s: devices is empty' % who)
    if len(devices) == 1:
        return devices[0], None
    return torch.device('cpu'), devices


def pad_chains(nchains, devices=None):
    """Round a chain count up to a multiple of the device count (the JAX
    package's arithmetic; the split itself needs no padding)."""
    ndev = len(devices) if devices is not None \
        else max(len(visible_devices()), 1)
    return int(np.ceil(nchains / ndev) * ndev)


def chain_sharding(nchains, devices=None, group=1):
    """The row block of each entry of ``devices`` (every visible CUDA
    device by default) as :class:`~bayhunter_tpu_torch.sampler.chain.Rows`:
    contiguous blocks of whole groups of ``group`` rows, as even as
    the groups allow (the first blocks one group larger)."""
    ndev = len(devices) if devices is not None \
        else max(len(visible_devices()), 1)
    if nchains % group:
        raise ValueError('%d chains are not whole groups of %d'
                         % (nchains, group))
    ngroups = nchains // group
    if ngroups < ndev:
        raise ValueError('%d group(s) of %d chains cannot be split over %d '
                         'devices: each needs a whole group'
                         % (ngroups, group, ndev))
    q, r = divmod(ngroups, ndev)
    bounds = np.cumsum([0] + [q + (i < r) for i in range(ndev)]) * group
    return [Rows(int(a), int(b), nchains)
            for a, b in zip(bounds[:-1], bounds[1:])]


def shard_states(states, blocks):
    """The states of each block: rows ``start:stop`` of every field and
    of the forward cache.  ``states`` is a ChainState, or a dict of its
    fields as numpy arrays (``convert.state_to_numpy``), and so is each
    block's."""
    fields = states if isinstance(states, dict) else vars(states)
    out = []
    for r in blocks:
        part = {k: tuple(tuple(a[r.start:r.stop] for a in entry)
                         for entry in v) if k == 'cache'
                else v[r.start:r.stop] for k, v in fields.items()}
        out.append(part if isinstance(states, dict) else ChainState(**part))
    return out


def gather_states(parts, device=None):
    """The inverse of :func:`shard_states`: one batch of the blocks'
    states in order, on ``device`` (the first block's by default)."""
    device = parts[0].n.device if device is None else torch.device(device)

    def cat(xs):
        return torch.cat([x.to(device) for x in xs])

    fields = {f: cat([getattr(p, f) for p in parts])
              for f in ChainState.__dataclass_fields__ if f != 'cache'}
    fields['cache'] = tuple(
        tuple(cat([p.cache[t][k] for p in parts])
              for k in range(len(parts[0].cache[t])))
        for t in range(len(parts[0].cache)))
    return ChainState(**fields)


def to_host(x):
    """``x`` with every tensor in it (in tuples, lists and dicts) as a
    numpy array: what a worker sends back."""
    if torch.is_tensor(x):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    return x


def concat(outs):
    """The blocks' host outputs joined along the chain axis: arrays
    concatenated, dicts and tuples key by key; one block's output is
    returned as it is."""
    if len(outs) == 1:
        return outs[0]
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: concat([o[k] for o in outs]) for k in first}
    if isinstance(first, tuple):
        return tuple(concat([o[i] for o in outs]) for i in range(len(first)))
    return np.concatenate(outs)


def worker_report(device):
    """What a worker returns when it closes: its device, its peak device
    memory (CUDA) and every kernel wrapper's launch counts."""
    from bayhunter_tpu_torch import ops
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else None
    return dict(device=str(device), peak_bytes=peak,
                launches=ops.launch_counts())


def _serve(conn, device, rows, build, args, nthreads):
    """A worker's loop: build ``build(device, rows, *args)``, answer
    ``('ok', None, seconds)``, then run each command and answer
    ``('ok', output, seconds)`` or ``('error', traceback, seconds)``,
    ``seconds`` the time the worker took.  A command ``('call', name, args)``
    runs ``states, out = obj.name(states, *args)`` on the worker's own
    states, ``('each', fn, args)`` runs ``fn(*args)``; None closes the
    worker, which answers with :func:`worker_report`."""
    torch.set_num_threads(nthreads)
    t = time.perf_counter()
    try:
        device = torch.device(device)
        obj = build(device, rows, *args)
        conn.send(('ok', None, time.perf_counter() - t))
    except Exception:
        conn.send(('error', traceback.format_exc(), 0.0))
        conn.close()
        return
    states = None
    while True:
        try:
            msg = conn.recv()
        except EOFError:         # the parent is gone
            return
        if msg is None:
            break
        kind, fn, fargs = msg
        t = time.perf_counter()
        try:
            if kind == 'call':
                states, out = getattr(obj, fn)(states, *fargs)
            else:
                out = fn(*fargs)
            out = to_host(out)
            conn.send(('ok', out, time.perf_counter() - t))
        except Exception:
            conn.send(('error', traceback.format_exc(), 0.0))
    conn.send(('ok', worker_report(device), 0.0))
    conn.close()


class WorkerError(RuntimeError):
    """A worker raised, exited without an answer or gave none in time."""


class Workers(object):
    """One spawned worker per entry of ``devices``, each owning the rows
    of its entry of ``blocks`` (:func:`chain_sharding`) and the object
    ``build(device, rows, *args)`` built in it (``build`` a module-level
    function, ``args`` picklable).  Workers take the parent's PyTorch
    thread count.  Use as a context manager, or :meth:`close` it; after
    an error :meth:`terminate` ends every worker.  :meth:`stats` times
    the pool: its start-up, and the commands' wall time beside the part
    that no worker was busy (pipes, pickling, waiting)."""

    def __init__(self, devices, blocks, build, args=(),
                 timeout=WORKER_TIMEOUT):
        if len(devices) != len(blocks):
            raise ValueError('%d devices for %d blocks'
                             % (len(devices), len(blocks)))
        self.devices = [torch.device(d) for d in devices]
        self.blocks = list(blocks)
        self.timeout = float(timeout)
        self.reports = None
        self._procs, self._conns = [], []
        self._calls, self._wall, self._idle = 0, 0.0, 0.0
        t = time.perf_counter()
        ctx = context()
        try:
            for dev, rows in zip(self.devices, self.blocks):
                ours, theirs = ctx.Pipe()
                proc = ctx.Process(target=_serve, daemon=True, args=(
                    theirs, str(dev), rows, build, tuple(args),
                    torch.get_num_threads()))
                proc.start()
                theirs.close()
                self._procs.append(proc)
                self._conns.append(ours)
            self._answers()
            self._start = time.perf_counter() - t
        except BaseException:
            self.terminate()
            raise

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        if kind is None:
            self.close()
        else:
            self.terminate()

    def _name(self, i):
        return 'worker %d (%s, rows %d:%d)' % (
            i, self.devices[i], self.blocks[i].start, self.blocks[i].stop)

    def _send(self, msgs):
        for i, (conn, msg) in enumerate(zip(self._conns, msgs)):
            try:
                conn.send(msg)
            except OSError as exc:
                raise WorkerError('%s is gone: %s (exit code %s)' % (
                    self._name(i), exc, self._procs[i].exitcode))

    def _answers(self):
        """Every worker's answer, in order; raises on an error."""
        outs = [None] * len(self._conns)
        busy = [0.0]
        errors = []
        pending = dict(enumerate(self._conns))
        deadline = time.monotonic() + self.timeout
        while pending:
            left = deadline - time.monotonic()
            waits = list(pending.values()) + [self._procs[i].sentinel
                                              for i in pending]
            if left <= 0 or not multiprocessing.connection.wait(waits,
                                                                left):
                raise WorkerError('no answer from %s in %.0f s' % (
                    ', '.join(self._name(i) for i in pending),
                    self.timeout))
            for i, conn in list(pending.items()):
                status = None
                if conn.poll():
                    try:
                        status, out, seconds = conn.recv()
                        busy.append(seconds)
                    except EOFError:     # it exited
                        self._procs[i].join(5)
                if status is None:
                    if self._procs[i].is_alive():
                        continue
                    self._procs[i].join()
                    status, out = 'error', (
                        'it exited with code %s without an answer'
                        % self._procs[i].exitcode)
                del pending[i]
                if status == 'ok':
                    outs[i] = out
                else:
                    errors.append('%s failed: %s' % (self._name(i), out))
        if errors:
            raise WorkerError('\n'.join(errors))
        return outs, max(busy)

    def _command(self, msgs):
        t = time.perf_counter()
        self._send(msgs)
        outs, busy = self._answers()
        wall = time.perf_counter() - t
        self._calls += 1
        self._wall += wall
        self._idle += max(wall - busy, 0.0)
        return outs

    def call(self, name, *args, each=None):
        """Run ``states, out = obj.name(states, *args, *each[i])`` in
        every worker i at once; returns the outputs in order."""
        return self._command([('call', name, tuple(args) + tuple(
            each[i] if each is not None else ()))
            for i in range(len(self._conns))])

    def each(self, fn, *args):
        """``fn(*args)`` run in every worker (``fn`` a module-level
        function); returns the results in order."""
        return self._command([('each', fn, tuple(args))]
                             * len(self._conns))

    def stats(self):
        """Seconds to start every worker, commands sent, their wall
        seconds and the seconds of it that no worker was busy."""
        return dict(start_s=self._start, commands=self._calls,
                    wall_s=self._wall, idle_s=self._idle)

    def close(self):
        """Close every worker and join it; returns (and keeps in
        ``reports``) each worker's :func:`worker_report` with its
        rows."""
        if self.reports is not None or not self._procs:
            return self.reports
        try:
            self._send([None] * len(self._conns))
            reports = self._answers()[0]
        except BaseException:
            self.terminate()
            raise
        for rep, rows in zip(reports, self.blocks):
            rep['rows'] = (rows.start, rows.stop)
        self._join()
        self.reports = reports
        return reports

    def terminate(self):
        """End every worker now and join it."""
        for proc in self._procs:
            if proc.is_alive():
                proc.terminate()
        self._join()

    def _join(self):
        for proc in self._procs:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
