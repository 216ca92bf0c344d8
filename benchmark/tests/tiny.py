"""Small versions of the cells' traffic for the CPU tests."""

import json

from conftest import BENCH


def config(name):
    return json.loads((BENCH / 'configs' / f'{name}.json').read_text())


def traffic(**kw):
    t = dict(jobs=2, families=5,
             family_size=dict(law='power', exponent=2, min=2, max=4),
             length=dict(law='lognormal', median=9000, sigma=0.4,
                         min=5000, max=16000))
    t.update(kw)
    return t


def cell(name):
    """The cell `name` (<config>.<traffic>) from its files, whether or not
    BENCHMARK.json lists it, with tiny traffic and the end-to-end metrics
    of BENCHMARK.json (and the members' kept share of its own traffic)."""
    import run
    spec = json.loads((BENCH.parent / 'BENCHMARK.json').read_text())
    cfg, mix = name.split('.')
    c = run.cell_from_files(dict(name=name, config=cfg, traffic=mix,
                                 chips=1), spec['end_to_end'], [])
    c['traffic'] = traffic(**{k: v for k, v in c['traffic'].items()
                              if k == 'kept_share'})
    return c
