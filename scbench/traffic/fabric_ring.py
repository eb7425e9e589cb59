"""Egress traffic of a fabric deployment: every tenant replays a GAPBS
kernel's SDM page trace into its own span, as the port's
``gapbs.egress_batches(page_offset, page_span)`` replays one.

Tenant ``t`` runs ``kernels[t % len(kernels)]`` over one RMAT graph made
from the seed, starting at an offset drawn from the seed.  A ring of
``ring_steps`` steps of ``words_per_row`` words a row is made on the
device.  In every (step, row) exactly ``round(foreign_share *
words_per_row)`` words, at positions drawn from the seed, are moved to the
same offset in another tenant's span: they carry the row's own tag and must
read denied.  Ciphertext words are drawn from the seed on the device."""
from __future__ import annotations

import numpy as np
import torch

from . import gapbs_traces as gt

HWPID_SHIFT = 24


def _draws(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, stream])


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        int(_draws(seed, stream).integers(0, 2**62)))


def keys(seed: int) -> tuple[int, int]:
    """The run's two 32-bit cipher keys."""
    k0, k1 = _draws(seed, 0).integers(0, 2**32, 2)
    return int(k0), int(k1)


def page_streams(config: dict, seed: int, n_rows: int, length: int,
                 device) -> torch.Tensor:
    """int64[R, length] page offsets inside each row's span, in program
    order."""
    rng = _draws(seed, 1)
    g = gt.make_graph(config["graph_scale"], config["graph_avg_degree"],
                      seed=int(rng.integers(2**31)))
    span = config["span_pages"]
    traces = {}
    for k in config["kernels"]:
        tr = gt.TRACES[k](g, seed=int(rng.integers(2**31)))
        traces[k] = torch.as_tensor(
            (np.asarray(tr.pages, np.int64) // gt.PAGE) % span,
            device=device)
    out = torch.empty((n_rows, length), dtype=torch.int64, device=device)
    steps = torch.arange(length, dtype=torch.int64, device=device)
    for r in range(n_rows):
        pages = traces[config["kernels"][r % len(config["kernels"])]]
        off = int(rng.integers(pages.shape[0]))
        out[r] = pages[(off + steps) % pages.shape[0]]
    return out


def make_ring(config: dict, params: dict, seed: int, hwpids: list[int],
              los: list[int], device) -> tuple[torch.Tensor, torch.Tensor]:
    """(ext int32[S, R, B], data int32[S, R, B]) for rows whose tenants
    hold ``hwpids`` with spans starting at page ``los``."""
    s, b = params["ring_steps"], params["words_per_row"]
    r = len(hwpids)
    gen = torch_generator(seed, 2, device)
    off = page_streams(config, seed, r, s * b, device) \
        .reshape(r, s, b).transpose(0, 1).contiguous()       # [S, R, B]
    lo = torch.as_tensor(los, dtype=torch.int64, device=device)
    n_foreign = round(params["foreign_share"] * b)
    owner = torch.arange(r, dtype=torch.int64, device=device)[
        None, :, None].expand(s, r, b).clone()
    pos = torch.rand((s, r, b), generator=gen, device=device) \
        .argsort(dim=-1)[:, :, :n_foreign]
    shift = torch.randint(1, r, (s, r, n_foreign), generator=gen,
                          device=device)
    owner.scatter_(2, pos, (owner.gather(2, pos) + shift) % r)
    pages = lo[owner] + off
    tags = torch.as_tensor(hwpids, dtype=torch.int64,
                           device=device)[None, :, None]
    ext = ((tags << HWPID_SHIFT) | pages).to(torch.int32)
    data = torch.randint(-2**31, 2**31 - 1, (s, r, b), dtype=torch.int32,
                         generator=gen, device=device)
    return ext, data


def retag_row(ext: torch.Tensor, row: int, old_lo: int, span: int,
              new_hwpid: int, new_lo: int) -> None:
    """Move a row's own-span words to a new tenant's span and tag, in
    place (its foreign words keep their pages): the replayed row follows
    the new assignment."""
    e = ext[:, row].to(torch.int64)
    page = e & ((1 << HWPID_SHIFT) - 1)
    own = (page >= old_lo) & (page < old_lo + span)
    page = torch.where(own, page - old_lo + new_lo, page)
    ext[:, row] = ((new_hwpid << HWPID_SHIFT) | page).to(torch.int32)
