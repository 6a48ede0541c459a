"""Masked fixed-width Voronoi-nuclei model on transposed (NL, C) planes.

Mirrors the transposed variants of ``bayhunter_tpu/ops/voronoi.py``:
``sort_by_depth_T``, ``voronoi_to_layers_T`` and ``model_is_valid_T``,
plus ``voronoi_to_layers`` for row-major (C, NL) batches (cold init).
Nuclei at index >= n are padding; the layered model replicates the
halfspace (nucleus n-1) into every padded slot with zero thickness.
"""

import torch

BIG_Z = 1e9  # sorting key of padded nuclei


def running_sum(x):
    """Inclusive cumulative sum along axis 0, accumulated layer by layer
    in order — the summation order of the model kernel on every
    device (a library scan may associate differently)."""
    acc = x[0]
    out = [acc]
    for row in x[1:]:
        acc = acc + row
        out.append(acc)
    return torch.stack(out, dim=0)


def _layer_index(nl, device):
    return torch.arange(nl, device=device)[:, None]          # (NL, 1)


def sort_by_depth_T(vs_t, z_t, n):
    """Stable sort of each chain's nuclei by depth along axis 0;
    padding (i >= n) keyed to the end."""
    nl = z_t.shape[0]
    idx = _layer_index(nl, z_t.device)
    zkey = torch.where(idx < n[None, :], z_t,
                       BIG_Z + idx.to(z_t.dtype))
    order = torch.sort(zkey, dim=0, stable=True).indices
    return torch.gather(vs_t, 0, order), torch.gather(z_t, 0, order)


def voronoi_to_layers_T(vs_t, z_t, n, vpvs, mantle=None):
    """(h, vp, vs, rho), each (NL, C), from (NL, C) nuclei; interfaces
    at the depth midpoints of consecutive nuclei, rho = 0.32 vp + 0.77.
    ``mantle`` = (vs threshold, mantle vp/vs) from the first nucleus at
    or above the threshold downward."""
    nl = vs_t.shape[0]
    idx = _layer_index(nl, vs_t.device)
    n_b = n[None, :]
    z_next = torch.cat([z_t[1:], z_t[-1:]], dim=0)
    z_disc = 0.5 * (z_t + z_next)
    z_disc_prev = torch.cat([torch.zeros_like(z_disc[:1]), z_disc[:-1]],
                            dim=0)
    zero = torch.zeros((), dtype=vs_t.dtype, device=vs_t.device)
    h = torch.where(idx < n_b - 1, z_disc - z_disc_prev, zero)

    vp = vs_t * vpvs[None, :]
    in_m = None
    if mantle is not None:
        is_m = (vs_t >= mantle[0]) & (idx < n_b)
        any_m = is_m.any(dim=0)
        first_m = torch.argmax(is_m.to(torch.int8), dim=0)
        in_m = any_m[None, :] & (idx >= first_m[None, :])
        vp = torch.where(in_m, vs_t * mantle[1], vp)

    finite = idx < n_b - 1
    hs_hot = idx == torch.clamp(n - 1, 0, nl - 1)[None, :]
    vs_hs = torch.sum(torch.where(hs_hot, vs_t, zero), dim=0)
    vp_hs = vs_hs * vpvs
    if mantle is not None:
        hs_in_m = (hs_hot & in_m).any(dim=0)
        vp_hs = torch.where(hs_in_m, vs_hs * mantle[1], vp_hs)
    vs_l = torch.where(finite, vs_t, vs_hs[None, :])
    vp_l = torch.where(finite, vp, vp_hs[None, :])
    rho = vp_l * 0.32 + 0.77
    return h, vp_l, vs_l, rho


def voronoi_to_layers(vs, z, n, vpvs, mantle=None):
    """Row-major (C, NL) form of :func:`voronoi_to_layers_T`."""
    out = voronoi_to_layers_T(vs.T, z.T, n, vpvs, mantle)
    return tuple(x.T.contiguous() for x in out)


def model_is_valid_T(vs_t, z_t, n, vpvs, priors, thickmin, lvz, hvz,
                     mantle=None):
    """Prior validity of (NL, C) models -> (C,) bool: layer count,
    minimum thickness, vs bounds, interface depths, optional low- and
    high-velocity-zone limits (``priors``: 'layers', 'vs', 'z')."""
    nl = vs_t.shape[0]
    idx = _layer_index(nl, vs_t.device)
    n_b = n[None, :]
    h_t = voronoi_to_layers_T(vs_t, z_t, n, vpvs, mantle)[0]
    valid = idx < n_b
    pair = idx < n_b - 1
    true = torch.ones((), dtype=torch.bool, device=vs_t.device)

    layermin, layermax = priors['layers']
    nlayer = n - 1
    ok = (nlayer >= layermin) & (nlayer <= layermax)
    all_ok = torch.where(pair, h_t >= thickmin, true)
    vsmin, vsmax = priors['vs']
    all_ok &= torch.where(valid, (vs_t >= vsmin) & (vs_t <= vsmax), true)
    zmin, zmax = priors['z']
    zc = running_sum(h_t)
    all_ok &= torch.where(valid, (zc >= zmin) & (zc <= zmax), true)
    vs_next = torch.cat([vs_t[1:], vs_t[-1:]], dim=0)
    if lvz is not None:
        all_ok &= torch.where(pair, vs_next - vs_t * (1.0 - lvz) > 0,
                              true)
    if hvz is not None:
        all_ok &= torch.where(pair, vs_t * (1.0 + hvz) - vs_next > 0,
                              true)
    return ok & all_ok.all(dim=0)
