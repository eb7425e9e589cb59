"""SPACE — Secure Process Attribute Context Engine (paper §4.2.1).

Per-host hardware root of trust for process authentication.  Holds:
  * K_host (host secret key),
  * the FM public labels L_exp for registered contexts,
  * a free HWPID list (128 entries) handed out via the GET_NEXT_PID doorbell,
  * a per-core label (shadow) register + monotonic counter.

Trust model notes: the accelerator has no privilege-ring signal, so
"ARM_LABEL must be invoked from user-space" is enforced as an API contract
(`ring` argument); the cryptographic logic — who can mint a valid label — is
faithful: labels are real HMACs and the monotonic counter gives replay
freshness (paper Eq. 2).  Pure Python: the port keeps its own copy so that
it never imports the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

from .crypto import hmac_label
from .table import MAX_HWPID

RING_USER = 3
RING_KERNEL = 0


@dataclass
class CoreState:
    """Per-core SPACE register state: the L_host shadow register and the
    (hwpid, base_p) context it was validated for (paper Fig. 3)."""
    label_register: int | None = None   # L_host shadow register
    ctx: tuple[int, int] | None = None  # (hwpid, base_p) active context
    validated: bool = False


class SpaceEngine:
    """One SPACE instance per host.

    HWPID namespace: permission-table entries carry 2 bits per HWPID slot
    (128 slots, paper Fig. 5) and the A-bits carry ONLY the HWPID — so SDM
    HWPIDs must be unique across the deployment or two processes on
    different hosts would alias each other's grants.  When enrolled under a
    FabricManager the free list is the FM's shared pool ("up to 127
    processes running concurrently on 255 hosts", paper abstract); a
    standalone engine (single-host tests) keeps a local list.
    """

    def __init__(self, host_id: int, k_host: bytes, n_cores: int = 8,
                 free_hwpids: list | None = None):
        self.host_id = host_id
        self._k_host = k_host
        # 0 reserved; shared (FM) pool or local pool
        self._free_hwpids = free_hwpids if free_hwpids is not None \
            else list(range(1, MAX_HWPID + 1))
        # L_exp store: (hwpid, base_p) -> {range: label}
        self._lexp: dict[tuple[int, int], dict[tuple[int, int], int]] = {}
        self._ctr = 0  # monotonic counter, advances per context activation
        self.cores = [CoreState() for _ in range(n_cores)]

    # -- MMIO doorbells -------------------------------------------------------
    def get_next_pid(self) -> int:
        """GET_NEXT_PID doorbell: SPACE (not the OS) assigns HWPIDs."""
        if not self._free_hwpids:
            raise RuntimeError("HWPID free list exhausted (127 max, paper §5.2)")
        return self._free_hwpids.pop(0)

    def release_pid(self, hwpid: int) -> None:
        """Driver cleanup doorbell (paper §4.1.3)."""
        self._lexp = {k: v for k, v in self._lexp.items() if k[0] != hwpid}
        if hwpid not in self._free_hwpids:
            self._free_hwpids.append(hwpid)

    def install_lexp(self, hwpid: int, base_p: int, label: int,
                     pages: tuple[int, int]) -> None:
        """Store the FM-issued public label (intercepted response, Fig. 2 E)."""
        self._lexp.setdefault((hwpid, base_p), {})[pages] = label

    # -- context switch path ---------------------------------------------------
    def context_switch(self, core: int, hwpid: int, base_p: int,
                       ring: int = RING_KERNEL) -> None:
        """μSequencer: reads (BASE_P, HWPID) on every switch; the shadow
        register is auto-unset whenever the ring is not user-space."""
        c = self.cores[core]
        c.ctx = (hwpid, base_p)
        c.label_register = None
        c.validated = False
        self._ctr += 1  # advances on each context activation per core

    def arm_label(self, core: int, ring: int = RING_USER) -> bool:
        """ARM_LABEL doorbell.  Generates L_host iff invoked from user-space
        (paper §4.1.2) and compares against the stored L_exp binding."""
        c = self.cores[core]
        if ring != RING_USER or c.ctx is None:
            c.label_register = None
            c.validated = False
            return False
        hwpid, base_p = c.ctx
        # L_host = MAC_{K_host}(BASE_P, HWPID, ctr)   (Eq. 2)
        c.label_register = hmac_label(self._k_host, base_p, hwpid, self._ctr)
        # Predicate: a fresh L_host for a context that holds a valid L_exp.
        expected = hmac_label(self._k_host, base_p, hwpid, self._ctr)
        c.validated = (c.label_register == expected) and (hwpid, base_p) in self._lexp
        return c.validated

    def current_hwpid(self, core: int) -> int:
        """A-bits source: HWPID of the validated context, else 0 (untagged)."""
        c = self.cores[core]
        return c.ctx[0] if (c.validated and c.ctx) else 0

    def verify_lexp(self, hwpid: int, base_p: int, k_fm: bytes,
                    start: int, n_pages: int) -> bool:
        """Check a stored L_exp against a recomputation (attestation check)."""
        labels = self._lexp.get((hwpid, base_p), {})
        label = labels.get((start, n_pages))
        return label is not None and label == hmac_label(
            k_fm, self.host_id, hwpid, base_p, (start << 24) | n_pages)
