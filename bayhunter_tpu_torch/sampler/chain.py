"""Transdimensional Metropolis-Hastings over a batch of chains.

Mirrors ``bayhunter_tpu/sampler/chain.py`` on its production path:
``make_config``, the chain state, the move algebra of ``propose_T`` /
``propose_dim_T`` (``:666-823``), ``accept_T`` (``:825-892``) with
Bodin birth/death acceptance, proposal-width adaptation and the
``accepted``/``proposed``/``fwdfail`` counters, the noise move
(``propose`` + ``eval_noise``), ``init_states_host`` (``:1024-1127``,
numpy draws kept verbatim so that initial states equal the JAX ones),
the early and mixed cycle bodies and ``dispatch_cycles``.

The random draws are kept out of the move math: every step takes a
``draws`` dict of per-chain tensors — ``index`` (nucleus, death or
noise-parameter index), ``normal``, ``uniform`` (birth depth),
``coin`` (True = birth) and ``logu`` (log acceptance uniform) — which
:meth:`Sampler.draw` fills from a ``torch.Generator``; a test can fill
it from any other source.

Model moves run on transposed (NL, C) planes, chains on the minor
axis, as the kernels take them.  The fixed-vp/vs configuration is the
one ported: vp/vs moves are still to be ported.
"""

import dataclasses
import typing

import numpy as np
import torch

from bayhunter_tpu_torch import DTYPE
from bayhunter_tpu_torch.ops import swd as _swd
from bayhunter_tpu_torch.ops import voronoi as _vor

MOVE_VS, MOVE_Z, MOVE_BIRTH, MOVE_DEATH, MOVE_NOISE, MOVE_VPVS = range(6)
# per-chain birth/death mixture slot of the fused cycles (counter slot
# 2, like birth and death)
MOVE_DIM = 6
PARIDX = (0, 1, 2, 2, 3, 4, 2)
WARM = {MOVE_VS: _swd.WARM_VS, MOVE_Z: _swd.WARM_Z,
        MOVE_DIM: _swd.WARM_DIM}


@dataclasses.dataclass
class ChainState:
    """Batched chain state; leading axis = chain."""
    vs: torch.Tensor          # (C, NL) nuclei velocities
    z: torch.Tensor           # (C, NL) nuclei depths (sorted over [:n])
    n: torch.Tensor           # (C,) int32 nuclei count incl. halfspace
    vpvs: torch.Tensor        # (C,)
    noise: torch.Tensor       # (C, 2T) [corr, sigma] per target
    logL: torch.Tensor        # (C,)
    misfits: torch.Tensor     # (C, T+1)
    propdist: torch.Tensor    # (C, 5)
    accepted: torch.Tensor    # (C, 5) int32
    proposed: torch.Tensor    # (C, 5) int32
    fwdfail: torch.Tensor     # (C, 5) int32 forward-solve rejects
    iiter: torch.Tensor       # (C,) int32, negative during burn-in
    cache: tuple              # per target (y, roots, slopes)
    beta: torch.Tensor        # (C,) inverse temperature


class SamplerConfig(typing.NamedTuple):
    """Static configuration (reference src/SingleChain.py:33-59)."""
    nl: int
    ntargets: int
    vs_prior: tuple
    z_prior: tuple
    layers_prior: tuple
    vpvs_prior: object
    mohoest: object
    mantle: object
    thickmin: float
    lvz: object
    hvz: object
    noise_priors: tuple
    propdist: tuple
    acceptance: tuple
    iter_burnin: int
    iter_main: int

    @property
    def noiseinds(self):
        return tuple(i for i, p in enumerate(self.noise_priors)
                     if not isinstance(p, (int, float)))

    @property
    def vpvs_inverted(self):
        return not isinstance(self.vpvs_prior, (int, float))


def make_config(priors, initparams, noiserefs, nl=None):
    """SamplerConfig from reference-style priors/initparams dicts and the
    targets' noiserefs ('swd'/'rf')."""
    layers = tuple(int(v) for v in priors['layers'])
    if nl is None:
        nl = layers[1] + 1
    noise_priors = []
    for nref in noiserefs:
        for pname in ('noise_corr', 'noise_sigma'):
            prior = priors[nref + pname]
            if isinstance(prior, (list, tuple)):
                noise_priors.append((float(prior[0]), float(prior[1])))
            else:
                noise_priors.append(float(prior))
    vpvs = priors['vpvs']
    vpvs = float(vpvs) if isinstance(vpvs, (int, float)) \
        else (float(vpvs[0]), float(vpvs[1]))

    def pair(x):
        return None if x is None else (float(x[0]), float(x[1]))

    def opt(x):
        return None if x is None else float(x)

    return SamplerConfig(
        nl=int(nl), ntargets=len(noiserefs),
        vs_prior=tuple(float(v) for v in priors['vs']),
        z_prior=tuple(float(v) for v in priors['z']),
        layers_prior=layers, vpvs_prior=vpvs,
        mohoest=pair(priors.get('mohoest')),
        mantle=pair(priors.get('mantle')),
        thickmin=float(initparams['thickmin']),
        lvz=opt(initparams.get('lvz', priors.get('lvz'))),
        hvz=opt(initparams.get('hvz', priors.get('hvz'))),
        noise_priors=tuple(noise_priors),
        propdist=tuple(float(v) for v in initparams['propdist']),
        acceptance=tuple(float(v) for v in initparams['acceptance']),
        iter_burnin=int(initparams['iter_burnin']),
        iter_main=int(initparams['iter_main']))


def _pick_T(x_t, ind):
    """x_t[ind[c], c] -> (C,)."""
    return torch.gather(x_t, 0, ind[None, :].to(torch.int64))[0]


class Sampler:
    """Moves, acceptance and cycles of one configuration."""

    def __init__(self, evaluator, cfg, device):
        if cfg.vpvs_inverted:
            raise NotImplementedError('vp/vs moves are not ported yet')
        if cfg.mantle is not None:
            raise NotImplementedError('the mantle prior is not ported yet')
        self.ev = evaluator
        self.cfg = cfg
        self.device = torch.device(device)
        self.nl = cfg.nl
        noiseinds = cfg.noiseinds
        self.noiseinds = torch.tensor(noiseinds, dtype=torch.int64,
                                      device=self.device)
        n_noise = len(cfg.noise_priors)
        lo = np.full(n_noise, -np.inf)
        hi = np.full(n_noise, np.inf)
        for i, p in enumerate(cfg.noise_priors):
            if not isinstance(p, (int, float)):
                lo[i], hi[i] = p
        self.noise_lo = torch.tensor(lo, dtype=DTYPE, device=self.device)
        self.noise_hi = torch.tensor(hi, dtype=DTYPE, device=self.device)
        self.early_order = [MOVE_VS, MOVE_Z]
        self.late_order = [MOVE_VS, MOVE_Z, MOVE_DIM, MOVE_DIM]
        active = [MOVE_VS, MOVE_Z, MOVE_BIRTH]
        if noiseinds:
            self.early_order.append(MOVE_NOISE)
            self.late_order.append(MOVE_NOISE)
            active.append(MOVE_NOISE)
        slots = np.zeros(5, bool)
        slots[[PARIDX[m] for m in active]] = True
        self.active_slots = torch.tensor(slots, device=self.device)
        iterations = cfg.iter_burnin + cfg.iter_main
        self.early_cutoff = -cfg.iter_burnin + iterations * 0.01
        self.idx_col = torch.arange(cfg.nl, device=self.device)[:, None]

    # ------------------------------------------------------------------
    # random draws
    # ------------------------------------------------------------------

    def draw(self, gen, states, move):
        """Per-chain randoms of one step of ``move`` from ``gen``."""
        C = states.n.shape[0]
        dev = states.n.device

        def uniform():
            return torch.rand(C, generator=gen, device=dev, dtype=DTYPE)

        def index(m):
            i = torch.floor(uniform() * m.to(DTYPE)).to(torch.int64)
            return torch.minimum(i, m.to(torch.int64) - 1)

        d = {}
        if move == MOVE_DIM:
            d['coin'] = uniform() < 0.5
            zmin, zmax = self.cfg.z_prior
            d['uniform'] = zmin + (zmax - zmin) * uniform()
        if move == MOVE_NOISE:
            d['index'] = index(torch.full((C,), len(self.cfg.noiseinds),
                                          device=dev))
        else:
            d['index'] = index(states.n)
        d['normal'] = torch.randn(C, generator=gen, device=dev,
                                  dtype=DTYPE)
        d['logu'] = torch.log(uniform())
        return d

    # ------------------------------------------------------------------
    # moves on (NL, C) planes
    # ------------------------------------------------------------------

    def _move_birth_T(self, vs_t, z_t, st, draws):
        nl = self.nl
        z_birth = draws['uniform']
        inf = torch.full_like(z_t, float('inf'))
        dist = torch.where(self.idx_col < st.n[None, :],
                           torch.abs(z_t - z_birth[None, :]), inf)
        vs_before = _pick_T(vs_t, torch.argmin(dist, dim=0))
        vs_birth = vs_before + draws['normal'] * st.propdist[:, 2]
        slot = torch.clamp(st.n, max=nl - 1)
        at_slot = self.idx_col == slot[None, :]
        vs_p = torch.where(at_slot, vs_birth[None, :], vs_t)
        z_p = torch.where(at_slot, z_birth[None, :], z_t)
        dvs = vs_birth - vs_before
        return vs_p, z_p, st.n + 1, dvs * dvs

    def _move_death_T(self, vs_t, z_t, st, draws):
        ind = draws['index']
        z_before = _pick_T(z_t, ind)
        vs_before = _pick_T(vs_t, ind)
        above = self.idx_col >= ind[None, :]
        vs_p = torch.where(above, torch.cat([vs_t[1:], vs_t[-1:]]), vs_t)
        z_p = torch.where(above, torch.cat([z_t[1:], z_t[-1:]]), z_t)
        n_new = st.n - 1
        inf = torch.full_like(z_t, float('inf'))
        dist = torch.where(self.idx_col < n_new[None, :],
                           torch.abs(z_p - z_before[None, :]), inf)
        vs_after = _pick_T(vs_p, torch.argmin(dist, dim=0))
        dvs = vs_after - vs_before
        return vs_p, z_p, n_new, dvs * dvs

    def propose_T(self, states, vs_t, z_t, move, draws):
        """Proposal of a vs or z move (validity comes from the model
        kernel)."""
        k = 0 if move == MOVE_VS else 1
        delta = draws['normal'] * states.propdist[:, k]
        hot = self.idx_col == draws['index'][None, :]
        step = torch.where(hot, delta[None, :], torch.zeros_like(vs_t))
        if move == MOVE_VS:
            vs_p, z_p = vs_t + step, z_t
        else:
            vs_p, z_p = _vor.sort_by_depth_T(vs_t, z_t + step, states.n)
        return dict(vs_t=vs_p, z_t=z_p, n=states.n,
                    dvs2=torch.zeros_like(delta), logu=draws['logu'])

    def propose_dim_T(self, states, vs_t, z_t, draws):
        """Per-chain fair birth/death mixture: both directions from the
        same draws, an independent coin per chain picks one."""
        vs_b, z_b, n_b, dvs2_b = self._move_birth_T(vs_t, z_t, states,
                                                    draws)
        vs_d, z_d, n_d, dvs2_d = self._move_death_T(vs_t, z_t, states,
                                                    draws)
        coin = draws['coin']
        vs_p = torch.where(coin[None, :], vs_b, vs_d)
        z_p = torch.where(coin[None, :], z_b, z_d)
        n_p = torch.where(coin, n_b, n_d)
        vs_p, z_p = _vor.sort_by_depth_T(vs_p, z_p, n_p)
        one = torch.ones_like(dvs2_b)
        return dict(vs_t=vs_p, z_t=z_p, n=n_p,
                    dvs2=torch.where(coin, dvs2_b, dvs2_d),
                    logu=draws['logu'], dim_sign=torch.where(coin, one,
                                                             -one))

    # ------------------------------------------------------------------
    # acceptance
    # ------------------------------------------------------------------

    def log_alpha(self, states, prop, logL_p):
        """Log acceptance ratio: tempered likelihood ratio plus, for
        dimension moves, the Bodin et al. (2012) birth/death terms."""
        vsmin, vsmax = self.cfg.vs_prior
        theta = states.propdist[:, 2]
        alpha = states.beta * (logL_p - states.logL)
        if 'dim_sign' in prop:
            log_a_birth = torch.log(theta * float(np.sqrt(2.0 * np.pi))
                                    / (vsmax - vsmin))
            b_term = prop['dvs2'] / (2.0 * (theta * theta))
            alpha = alpha + prop['dim_sign'] * (log_a_birth + b_term)
        return alpha

    def accept(self, states, move, prop, valid, logL_p, misfits_p, fvalid,
               cache_p, vs_t=None, z_t=None):
        """Metropolis(-Hastings-Green) acceptance, counters and
        proposal-width adaptation; model fields are selected in the
        (NL, C) layout when ``vs_t`` is given."""
        alpha = self.log_alpha(states, prop, logL_p)
        accept = (prop['logu'] < alpha) & valid & fvalid
        acc = accept[:, None]

        onehot = (torch.arange(5, device=accept.device)
                  == PARIDX[move])[None, :]
        zero = torch.zeros((), dtype=torch.int32, device=accept.device)
        one = torch.ones((), dtype=torch.int32, device=accept.device)
        proposed = states.proposed + torch.where(valid[:, None] & onehot,
                                                 one, zero)
        accepted = states.accepted + torch.where(acc & onehot, one, zero)
        fwdfail = states.fwdfail + torch.where(
            (valid & ~fvalid)[:, None] & onehot, one, zero)

        lo, hi = self.cfg.acceptance
        do_adapt = (torch.remainder(states.iiter, 1000) == 0) & (
            (proposed > 0) | ~self.active_slots[None, :]).all(dim=1)
        rates = (accepted.to(DTYPE)
                 / torch.clamp(proposed, min=1).to(DTYPE) * 100.0)
        factor = torch.where(rates < lo, 0.95, torch.where(rates > hi,
                                                           1.05, 1.0))
        factor = torch.where(proposed > 0, factor, 1.0).to(DTYPE)
        new_pd = states.propdist * factor
        new_pd = torch.where((rates < lo) & (proposed > 0),
                             torch.clamp(new_pd, min=0.001), new_pd)
        propdist = torch.where(do_adapt[:, None], new_pd, states.propdist)

        def sel(new, old):
            a = accept.reshape((-1,) + (1,) * (new.ndim - 1))
            return torch.where(a, new, old)

        if vs_t is not None:
            vs = torch.where(accept[None, :], prop['vs_t'], vs_t).T
            z = torch.where(accept[None, :], prop['z_t'], z_t).T
            n = torch.where(accept, prop['n'], states.n)
        else:
            vs, z, n = states.vs, states.z, states.n
        noise = sel(prop['noise'], states.noise) if 'noise' in prop \
            else states.noise
        return ChainState(
            vs=vs.contiguous(), z=z.contiguous(), n=n,
            vpvs=states.vpvs, noise=noise,
            logL=sel(logL_p, states.logL),
            misfits=sel(misfits_p, states.misfits),
            propdist=propdist, accepted=accepted, proposed=proposed,
            fwdfail=fwdfail, iiter=states.iiter + 1,
            cache=tuple(tuple(sel(a, b) for a, b in zip(cn, co))
                        for cn, co in zip(cache_p, states.cache)),
            beta=states.beta)

    # ------------------------------------------------------------------
    # steps and cycles
    # ------------------------------------------------------------------

    def step(self, states, move, draws):
        """One iteration of every chain with ``move`` (MOVE_VS, MOVE_Z,
        MOVE_DIM or MOVE_NOISE)."""
        if move == MOVE_NOISE:
            return self._step_noise(states, draws)
        vs_t, z_t = states.vs.T, states.z.T
        if move == MOVE_DIM:
            prop = self.propose_dim_T(states, vs_t, z_t, draws)
        else:
            prop = self.propose_T(states, vs_t, z_t, move, draws)
        logL_p, misfits_p, fvalid, cache_p, mvalid = \
            self.ev.eval_full_batch_t(
                prop['vs_t'].contiguous(), prop['z_t'].contiguous(),
                prop['n'], states.vpvs, states.noise, states.cache,
                WARM[move])
        return self.accept(states, move, prop, mvalid, logL_p, misfits_p,
                           fvalid, cache_p, vs_t, z_t)

    def _step_noise(self, states, draws):
        """Perturb one free noise hyperparameter; re-score the cached
        synthetics."""
        ind = self.noiseinds[draws['index']]
        delta = draws['normal'] * states.propdist[:, 3]
        cols = torch.arange(states.noise.shape[1], device=ind.device)
        noise_p = states.noise + torch.where(
            cols[None, :] == ind[:, None], delta[:, None],
            torch.zeros_like(states.noise))
        valid = ((noise_p >= self.noise_lo) & (noise_p <= self.noise_hi)
                 ).all(dim=1)
        logL_p, fvalid = self.ev.eval_noise(noise_p, states.cache)
        prop = dict(noise=noise_p, logu=draws['logu'])
        return self.accept(states, MOVE_NOISE, prop, valid, logL_p,
                           states.misfits, fvalid, states.cache)

    def cycle(self, states, order, gen):
        """One sweep over ``order`` — ``early_order`` (vs, z, noise;
        dimension moves locked out early) or ``late_order`` (vs, z, dim,
        dim, noise with per-chain birth/death slots) — drawing each
        step's randoms from ``gen``."""
        for move in order:
            states = self.step(states, move, self.draw(gen, states, move))
        return states

    # ------------------------------------------------------------------
    # initial states
    # ------------------------------------------------------------------

    def _valid_host(self, vs_d, z_d, n_init):
        cfg = self.cfg
        z_next = np.concatenate([z_d[:, 1:], z_d[:, -1:]], axis=1)
        z_disc = 0.5 * (z_d + z_next)
        h = np.diff(np.concatenate(
            [np.zeros((z_d.shape[0], 1)), z_disc], axis=1), axis=1)
        ok = np.all(h[:, :n_init - 1] >= cfg.thickmin, axis=1)
        dvs = vs_d[:, 1:]
        vs0 = vs_d[:, :-1]
        if cfg.lvz is not None:
            ok &= np.all(dvs > vs0 * (1.0 - cfg.lvz), axis=1)
        if cfg.hvz is not None:
            ok &= np.all(dvs < vs0 * (1.0 + cfg.hvz), axis=1)
        return ok

    def init_states_host(self, seed, nchains):
        """Draw ``nchains`` valid initial states with numpy (the JAX
        package's draws, verbatim) and evaluate them cold.  Returns
        ``(states, generator)``: the sampler's ``torch.Generator`` is
        seeded from the same numpy stream."""
        cfg = self.cfg
        nl = self.nl
        vsmin, vsmax = cfg.vs_prior
        zmin, zmax = cfg.z_prior
        n_init = cfg.layers_prior[0] + 1
        rs = np.random.RandomState(seed)
        vs_h = np.empty((nchains, n_init))
        z_h = np.empty((nchains, n_init))
        pending = np.arange(nchains)
        for _ in range(1000):
            if pending.size == 0:
                break
            m = pending.size
            vs_d = np.sort(rs.uniform(vsmin, vsmax, (m, n_init)), axis=1)
            if cfg.mohoest is not None and n_init > 1:
                mean, std = cfg.mohoest
                moho = rs.normal(mean, std, (m, 1))
                tmp_z = rs.uniform(1.0, np.minimum(5.0, moho), (m, 1))
                z_d = rs.uniform(zmin, zmax, (m, n_init))
                z_d[:, :1] = moho - tmp_z
                z_d[:, 1:2] = moho + tmp_z
                z_d = np.sort(z_d, axis=1)
            else:
                z_d = np.sort(rs.uniform(zmin, zmax, (m, n_init)), axis=1)
            ok = self._valid_host(vs_d, z_d, n_init)
            took = pending[ok]
            vs_h[took] = vs_d[ok]
            z_h[took] = z_d[ok]
            pending = pending[~ok]
        if pending.size:
            raise RuntimeError('could not draw valid initial models '
                               'under the given priors')
        vpvs_h = np.full(nchains, float(cfg.vpvs_prior))
        n_noise = len(cfg.noise_priors)
        noise_h = np.empty((nchains, max(n_noise, 1)))
        for i, p in enumerate(cfg.noise_priors):
            if isinstance(p, (int, float)):
                noise_h[:, i] = p
            else:
                noise_h[:, i] = rs.uniform(p[0], p[1], nchains)
        vs_full = np.concatenate(
            [vs_h, np.repeat(vs_h[:, -1:], nl - n_init, axis=1)], axis=1)
        z_full = np.concatenate(
            [z_h, np.full((nchains, nl - n_init), 2.0 * zmax)], axis=1)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rs.randint(2 ** 31)))

        dev = self.device

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=dev)

        vs_j, z_j, vpvs_j, noise_j = (f32(x) for x in (vs_full, z_full,
                                                       vpvs_h, noise_h))
        n_j = torch.full((nchains,), n_init, dtype=torch.int32, device=dev)
        logL, misfits, _, cache = self.ev.eval_cold(vs_j, z_j, n_j, vpvs_j,
                                                    noise_j)

        def zeros5():
            return torch.zeros((nchains, 5), dtype=torch.int32, device=dev)

        states = ChainState(
            vs=vs_j, z=z_j, n=n_j, vpvs=vpvs_j, noise=noise_j, logL=logL,
            misfits=misfits,
            propdist=f32(np.broadcast_to(cfg.propdist, (nchains, 5))),
            accepted=zeros5(), proposed=zeros5(), fwdfail=zeros5(),
            iiter=torch.full((nchains,), -cfg.iter_burnin,
                             dtype=torch.int32, device=dev),
            cache=cache, beta=torch.ones(nchains, dtype=DTYPE, device=dev))
        return states, gen


def remainder_moves(sampler, it_global, count, gen):
    """Moves of global iterations it_global .. it_global + count - 1 on
    the JAX package's random-scan schedule (``_move_for``, used there
    for a remainder shorter than a cycle): each iteration's move drawn
    uniformly from ``early_order`` before the sampler's early cutoff and
    from ``late_order`` after it, per iteration, with uniforms from
    ``gen``.  ``late_order``'s two MOVE_DIM entries stand for JAX's
    birth and death."""
    u = torch.rand(count, generator=gen, device=gen.device,
                   dtype=torch.float64).cpu().numpy()
    moves = []
    for k in range(count):
        order = sampler.early_order if it_global + k < sampler.early_cutoff \
            else sampler.late_order
        moves.append(order[min(int(u[k] * len(order)), len(order) - 1)])
    return moves


def dispatch_cycles(sampler, states, it_global, count, gen):
    """Advance ``states`` exactly ``count`` iterations from global
    iteration ``it_global`` (counted like ``iiter``): whole early
    cycles before the sampler's ``early_cutoff``, mixed cycles after
    it; a remainder shorter than a cycle runs step by step on the
    random-scan schedule of :func:`remainder_moves`."""
    done = 0
    while done < count:
        early = (it_global + done) < sampler.early_cutoff
        order = sampler.early_order if early else sampler.late_order
        if count - done < len(order):
            for move in remainder_moves(sampler, it_global + done,
                                        count - done, gen):
                states = sampler.step(states, move,
                                      sampler.draw(gen, states, move))
            break
        states = sampler.cycle(states, order, gen)
        done += len(order)
    return states
