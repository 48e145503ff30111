"""The comparison that decides ``correct``, at sizes a test run holds on
the CPU (the runners are eager there; the card runs them graphed): a
sound run is correct; the control (the reference in the next precision
down, put in the program's place) is not; and a run with the timed path
broken underneath is not, for each fault a training cell can have: a
step that leaves its state unchanged, and half of each batch left out
with the mean taken over the rest; and, for CelebA, the spectral-norm
refresh after each step left out. The card's own readings, at the
cells' sizes, are in PERF.md."""
import pytest

from conftest import SMALL

CELLS = ["pendulum-cdgvae.fixed", "pendulum-cdgvae.online",
         "celeba-cdgvae.f32"]

PRELUDE = """
import json, sys, torch
torch.set_num_threads(2)
sys.path.insert(0, '.')
from benchmark.manifest import Cell
from benchmark import compare, calibrate, run
cell = Cell({cell!r})
cell.config.update({small!r})
"""

UNCHANGED = """
import cdgvae_torch.train.steps as S
S.CapturableAdam.step = lambda self, closure=None: None
torch.optim.Adam.step = lambda self, closure=None: None
"""

HALF = """
import cdgvae_torch.train.steps as S
import cdgvae_torch.train.scanned as SC
import cdgvae_torch.train.celeba_steps as C

def halved(fn):
    def f(x, y, **kw):
        h = x.shape[0] // 2
        if torch.is_tensor(kw.get('noise')):
            kw['noise'] = kw['noise'][:h]
        return fn(x[:h], y[:h], **kw)
    return f

def maker(make):
    return lambda *a, **k: halved(make(*a, **k))

S.make_train_step = maker(S.make_train_step)
SC.make_supervised_loss_fn = maker(SC.make_supervised_loss_fn)
C.make_celeba_step = maker(C.make_celeba_step)
"""

SN_SKIPPED = """
import cdgvae_torch.models.sagan as SG
SG.sn_refresh = lambda module, iters=1: None
"""

RUN = """
res = run.run_cell(cell, {seed}, 0.0, False, torch.device('cpu'))
print(json.dumps({{'correct': res['correct'], 'checks': res['checks']}}))
"""


def code(cell, seed, patch=""):
    small = SMALL[cell.split(".")[0]]
    return PRELUDE.format(cell=cell, small=small) + patch \
        + RUN.format(seed=seed)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(run_py, cell):
    out = run_py(code(cell, 2147483801))
    assert out["correct"], out["checks"]


FAULTS = {"unchanged": UNCHANGED, "half_batch": HALF,
          "sn_skipped": SN_SKIPPED}


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in CELLS for fault in ("unchanged", "half_batch")]
    + [("celeba-cdgvae.f32", "sn_skipped")])
def test_a_broken_step_is_not_correct(run_py, cell, fault):
    out = run_py(code(cell, 2147483802, FAULTS[fault]))
    assert not out["correct"], out["checks"]


CONTROL = """
out = []
for seed in (11, 12, 13):
    r = calibrate.readings(cell, seed, torch.device('cpu'), True)
    out.append(compare.judge(r['control'], cell.limits)[0])
print(json.dumps(out))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(run_py, cell):
    small = SMALL[cell.split(".")[0]]
    out = run_py(PRELUDE.format(cell=cell, small=small) + CONTROL.format())
    assert out == [False, False, False]
