"""Traffic is a function of the seed: the same seed makes the same ring,
another seed another one, with the same amount of work."""
import torch

from scbench import harness
from scbench.tests import _tiny
from scbench.traffic import fabric_ring

CFG = {**harness.load_json(harness.ROOT / "configs" / "sc-255h-127p.json"),
       **_tiny.FABRIC["config"]}
PARAMS = {"ring_steps": 2, "words_per_row": 1024, "foreign_share": 0.01}
HWPIDS, LOS = [1, 2, 3, 4], [0, 256, 512, 768]


def ring(seed):
    return fabric_ring.make_ring(CFG, PARAMS, seed, HWPIDS, LOS,
                                 torch.device("cpu"))


def test_same_seed_same_ring():
    a, b = ring(2**31 + 3), ring(2**31 + 3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert fabric_ring.keys(5) == fabric_ring.keys(5)


def test_other_seed_other_ring_same_work():
    (e1, d1), (e2, d2) = ring(1), ring(2)
    assert not torch.equal(e1, e2) and not torch.equal(d1, d2)
    for ext in (e1, e2):
        page = ext.long() & 0xFFFFFF
        lo = torch.tensor(LOS)[None, :, None]
        own = (page >= lo) & (page < lo + CFG["span_pages"])
        assert ((~own).sum(-1) == round(0.01 * 1024)).all()
        assert ((ext.long() >> 24) == torch.tensor(HWPIDS)[None, :, None]
                ).all()


def test_retag_moves_own_words_only():
    ext, _ = ring(9)
    before = ext.clone()
    fabric_ring.retag_row(ext, 1, 256, CFG["span_pages"], 9, 1024)
    page = before[:, 1].long() & 0xFFFFFF
    own = (page >= 256) & (page < 256 + CFG["span_pages"])
    after = ext[:, 1].long()
    assert ((after >> 24) == 9).all()
    assert torch.equal((after & 0xFFFFFF)[own], page[own] - 256 + 1024)
    assert torch.equal((after & 0xFFFFFF)[~own], page[~own])
    assert torch.equal(ext[:, 0], before[:, 0])
