"""The plain egress reference against the port's own plain version (two
independent writings of one definition), and its ledger."""
import numpy as np
import pytest
import torch

from repro_torch.core.crypto import arx_mac32
from repro_torch.kernels import ref as port_ref
from scbench.reference import egress as ref


def test_keystream_matches_the_ports_arx():
    pos = torch.arange(0, 5000, 7, dtype=torch.int64) + (2**32 - 2000)
    for k0, k1 in ((0xAB, 0xCD), (2**32 - 1, 12345)):
        want, _ = arx_mac32(k0, k1, (pos & 0xFFFFFFFF) >> 4, pos & 15)
        assert torch.equal(ref.keystream(k0, k1, pos), want)


@pytest.mark.parametrize("live", [True, False])
def test_row_verdicts_match_the_ports_plain_egress(live):
    rng = np.random.default_rng(3)
    b, lo, n = 512, 1000, 64
    pages = np.where(rng.random(b) < 0.8, lo + rng.integers(0, n, b),
                     rng.integers(0, 4000, b))
    tags = rng.choice([5, 5, 5, 5, 0, 7, -1], b)
    ext = torch.as_tensor(((tags.astype(np.int64) << 24) | pages)
                          .astype(np.int32))
    data = torch.as_tensor(rng.integers(-2**31, 2**31, b, dtype=np.int64)
                           .astype(np.int32))
    starts = torch.tensor([lo], dtype=torch.int32)
    ends = starts + n
    perm = torch.tensor([3 if live else 0], dtype=torch.int32)
    want = port_ref.checked_memcrypt(data, ext, starts, ends, perm, hwpid=5,
                                     need=1, key0=11, key1=22, base_word=b)
    grants = ref.RowGrants(hwpid=torch.tensor([0, 5]),
                           lo=torch.tensor([0, lo]),
                           hi=torch.tensor([0, lo + n]),
                           entry=torch.tensor([False, True]),
                           live=torch.tensor([False, live]))
    got = ref.egress(torch.stack([data, data]), torch.stack([ext, ext]),
                     grants, key0=11, key1=22, words_per_row=b)
    assert torch.equal(got[0][1], want[0]) and torch.equal(got[1][1], want[1])


def test_ledger_counts_layout_violations():
    led = ref.GrantLedger([0, 1], n_hosts=2, sdm_pages=200, span_pages=50)
    led.admit(0, 1, 0)
    led.admit(1, 2, 100)
    assert led.violations == 0
    led.admit(1, 2, 80)              # starts below host 1's shard [100, 200)
    assert led.violations == 1
    two = ref.GrantLedger([0, 0], n_hosts=2, sdm_pages=200, span_pages=50)
    two.admit(0, 1, 0)
    two.admit(1, 2, 25)              # overlaps row 0's span
    assert two.violations == 1
    two.revoke(0)
    assert two.snapshot()[3] == (False, True)
