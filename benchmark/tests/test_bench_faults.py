"""The check catches a broken timed path: a run on the CPU at a tiny size
with the program broken underneath reads `correct` false, once for each
fault the cells can have. (One card and no state between calls: no
exchange between chips to drop, no step that keeps its state.)"""

import pytest

import run
from tiny import cell


def _run(monkeypatch, name='ictv_species.genus', whole=False):
    """A run of the tiny cell; `whole`: every member keeps its base's
    length, so the hybrid keeps v3's aggregates of most pairs."""
    monkeypatch.setenv('VCLUST_TORCH_DEVICE', 'cpu')
    monkeypatch.setattr(run, 'SAMPLE_PAIRS', 1000)   # every pair
    c = cell(name)
    if whole:
        c['traffic'].pop('kept_share', None)
    return run.run_cell(c, 77, 0.1, False, device='cpu')


def _wrap(monkeypatch, name, fn):
    from vclust_tpu_torch.ops import align_gpu as ag
    real = getattr(ag, name)
    monkeypatch.setattr(ag, name, lambda *a, **kw: fn(real(*a, **kw)))


def test_sound_run_is_correct(monkeypatch):
    assert _run(monkeypatch)['correct'] is True


@pytest.mark.parametrize('core,cell', [
    ('_row_core_v3', 'imgvr_votu.complete'), ('_row_core', 'ictv_species.genus')])
def test_answer_altered_where_produced(monkeypatch, core, cell):
    """One aggregate of each dispatch row's first pair, one higher (on v3
    in the vOTU cell with its members kept whole, where v3's aggregates
    stand for most pairs)."""
    def alter(agg):
        agg = agg.clone()
        agg[:, 0, 1] += 1
        return agg
    _wrap(monkeypatch, core, alter)
    res = _run(monkeypatch, cell, whole=core == '_row_core_v3')
    assert res['correct'] is False and res['failed'] > 0


def test_half_of_the_batch_left_out(monkeypatch):
    """Each v3 dispatch computes its first half of rows; the rest read
    zero."""
    def half(agg):
        agg = agg.clone()
        agg[(agg.shape[0] + 1) // 2:] = 0
        return agg
    _wrap(monkeypatch, '_row_core_v3', half)
    assert _run(monkeypatch)['correct'] is False


def test_hybrid_rerun_skipped(monkeypatch):
    """The control's path: the hybrid keeps v3's aggregates of the hard
    pairs (the program's own VCLUST_ALIGN_V3_COV=0)."""
    from vclust_tpu_torch.ops import align_gpu as ag
    monkeypatch.setattr(ag, 'V3_RERUN_COV', 0.0)
    assert _run(monkeypatch)['correct'] is False


def test_hybrid_rerun_skipped_members_whole(monkeypatch):
    """The same fault where members keep their base's length, with a
    sample of two pairs a stratum: the pairs v3 leaves hard are caught
    through the stratum of low coverage, not by chance."""
    from vclust_tpu_torch.ops import align_gpu as ag
    monkeypatch.setattr(ag, 'V3_RERUN_COV', 0.0)
    monkeypatch.setenv('VCLUST_TORCH_DEVICE', 'cpu')
    monkeypatch.setattr(run, 'SAMPLE_PAIRS', 2)
    monkeypatch.setattr(run, 'SAMPLE_FLOOR', 1)
    res = run.run_cell(cell('imgvr_votu.whole'), 77, 0.1, False,
                       device='cpu')
    assert res['correct'] is False and res['failed'] > 0


def test_lower_seed_density(monkeypatch):
    """The other control: v2 at 8 seeds a block (the program's own
    VCLUST_ALIGN_C=8, the two-phase screen's first density)."""
    from vclust_tpu_torch.ops import align_gpu as ag
    monkeypatch.setattr(ag, 'SEEDS_PER_BLOCK', 8)
    assert _run(monkeypatch)['correct'] is False


