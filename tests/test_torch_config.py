"""The port's copies of the JAX package's host modules against their
originals (CPU, exact): ``config`` (the INI contract, the shipped
defaults and the tutorial's configuration, the config pickles),
``diagnostics`` (split-R-hat, ESS) and ``synthobs`` (the seeded
correlated-noise draws, the expected likelihood, the ASCII writers).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from bayhunter_tpu import config as jconfig  # noqa: E402
from bayhunter_tpu import diagnostics as jdiag  # noqa: E402
from bayhunter_tpu import synthobs as jsynth  # noqa: E402
from bayhunter_tpu_torch import Targets, config, diagnostics  # noqa: E402
from bayhunter_tpu_torch import synthobs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_defaults_are_a_copy():
    path = config.get_path('defaults.ini')
    assert path.startswith(os.path.join(ROOT, 'bayhunter_tpu_torch'))
    with open(path) as a, open(jconfig.get_path('defaults.ini')) as b:
        assert a.read() == b.read()
    with pytest.raises(OSError):
        config.get_path('absent.ini')


@pytest.mark.parametrize('ini', ['defaults', 'tutorial'])
def test_load_params_matches_jax(ini):
    if ini == 'defaults':
        port, ref = config.get_path('defaults.ini'), \
            jconfig.get_path('defaults.ini')
    else:
        port = ref = os.path.join(ROOT, 'tutorial', 'config.ini')
    got, want = config.load_params(port), jconfig.load_params(ref)
    assert got == want
    priors, initparams = got
    assert isinstance(priors['vpvs'], tuple) and initparams['maxmodels'] > 0


def test_load_params_user_matches_jax(tmp_path):
    data = tmp_path / 'st1_rdispph.dat'
    data.write_text('1 3.0\n2 3.1\n')
    ini = tmp_path / 'user.ini'
    ini.write_text('[datapaths]\nrdispph = %s/%%s_rdispph.dat\n'
                   '[modelpriors]\nvpvs = 1.6, 1.9\nlayers = 1, 9\n'
                   '[initparams]\nnchains = 4\nsavepath = out/%%s_%%s\n'
                   % tmp_path)
    assert config.load_params_user(str(ini), 'st1') == \
        jconfig.load_params_user(str(ini), 'st1')


def test_config_pickles_round_trip(tmp_path):
    x = np.linspace(1, 40, 5)
    joint = Targets.JointTarget([Targets.RayleighDispersionPhase(x, x)])
    out = str(tmp_path / 'test_config.pkl')
    config.save_config(joint, out, priors={'vpvs': 1.73},
                       initparams={'nchains': 2})
    data = config.read_config(out)
    assert data['targetrefs'] == ['rdispph']
    assert data['priors'] == {'vpvs': 1.73}
    assert jconfig.read_config(out)['initparams'] == {'nchains': 2}
    config.save_baywatch_config(joint, path=str(tmp_path),
                                refmodel={'nlays': 3})
    assert config.read_config(str(tmp_path / 'baywatch.pkl'))[
        'refmodel'] == {'nlays': 3}


def test_diagnostics_match_jax():
    rs = np.random.RandomState(4)
    traces = {'logL': rs.normal(0, 1, (8, 200)).cumsum(axis=1),
              'vpvs': rs.normal(1.7, 0.02, (8, 200))}
    assert diagnostics.convergence_report(traces) == \
        jdiag.convergence_report(traces)
    for x in traces.values():
        assert diagnostics.split_rhat(x) == jdiag.split_rhat(x)
        assert diagnostics.ess(x) == jdiag.ess(x)
    assert diagnostics.split_rhat(np.ones((3, 10))) == 1.0


def test_synthobs_noise_and_likelihood_match_jax(monkeypatch):
    y = np.linspace(0, 1, 201)
    draws = []
    for mod in (synthobs, jsynth):
        monkeypatch.setattr(mod, 'rstate', np.random.RandomState(333))
        e = mod.SynthObs.compute_expnoise(y[:21], corr=0.0, sigma=0.012)
        g = mod.SynthObs.compute_gaussnoise(y, corr=0.98, sigma=0.005)
        x = mod.SynthObs.compute_expnoise(y[:30], corr=0.6, sigma=0.01)
        draws.append((e, g, x))
    for a, b in zip(*draws):
        assert np.array_equal(a, b)
    e, g, _ = draws[0]
    kw = dict(yobss=[y[:21] + e, y + g], ymods=[y[:21], y],
              noise=[0.0, 0.012, 0.98, 0.005], gauss=[False, True],
              rcond=1e-5)
    assert synthobs.SynthObs.compute_explike(**kw) == \
        jsynth.SynthObs.compute_explike(**kw)
    kw.update(noise=[0.4, 0.012, 0.6, 0.005], gauss=[False, False])
    assert synthobs.SynthObs.compute_explike(**kw) == \
        jsynth.SynthObs.compute_explike(**kw)


def test_synthobs_writers_match_jax(tmp_path):
    data = {'rdispph': (np.linspace(1, 40, 5), np.linspace(3, 4, 5))}
    for mod, tag in ((synthobs, 'port'), (jsynth, 'jax')):
        mod.SynthObs.save_data(data, str(tmp_path / ('%s.dat' % tag)))
        mod.SynthObs.save_model([5, 23, 8, 0], [2.7, 3.6, 3.8, 4.4],
                                outfile=str(tmp_path / ('%s_mod.dat' % tag)))
    for a, b in (('port_rdispph.dat', 'jax_rdispph.dat'),
                 ('port_mod.dat', 'jax_mod.dat')):
        assert (tmp_path / a).read_text() == (tmp_path / b).read_text()
    # the synthetic data come through the forward plugins now (the
    # kernels' twins on the CPU; tests/test_torch_targets.py holds them
    # against the JAX package's)
    for fn, refs in ((synthobs.SynthObs.return_swddata,
                      ['ldispgr', 'ldispph', 'rdispgr', 'rdispph']),
                     (synthobs.SynthObs.return_rfdata, ['prf', 'srf'])):
        out = fn([5, 0], [3.0, 4.0], device='cpu')
        assert sorted(out) == refs
        assert all(np.all(np.isfinite(v)) for v in out.values())
