"""Space-Control core on PyTorch: process-level isolation for shared
disaggregated memory, with the checked egress path on the GPU.

Paper components -> modules:
  SPACE engine        -> repro_torch.core.space.SpaceEngine
  Permission table    -> repro_torch.core.table (PermissionTable / HostTable)
  Permission checker  -> repro_torch.core.checker.check_access
  Permission cache    -> repro_torch.core.checker.PermCache
                         (LRU model: repro_torch.core.cache.LruCache)
  Fabric manager      -> repro_torch.core.fm.FabricManager
  Sharded fabric      -> repro_torch.core.fabric.ShardedFabric
  Shared tensor pool  -> repro_torch.core.pool.SharedTensorPool
  Fault injection     -> repro_torch.core.faults.FaultPlan
"""
from .bus import BISnpBus
from .cache import LruCache
from .checker import (
    FAULT_DESYNC,
    FAULT_NO_ABITS,
    FAULT_NO_ENTRY,
    FAULT_NONE,
    FAULT_NOT_LOCAL,
    FAULT_PERM,
    PERM_CACHE_BYTES,
    CheckResult,
    PermCache,
    binary_search,
    cached_check_access,
    check_access,
    desync_check_result,
    invalidate_perm_cache,
    make_hwpid_local,
    make_perm_cache,
)
from .crypto import arx_mac32, arx_mac64, derive_key, hmac_label
from .fabric import FabricView, HostRuntime, ShardedFabric, stack_views
from .faults import FaultPlan, FaultSpec, LinkFault
from .fm import (BISnpEvent, FabricManager, FMUnavailable, JournalRecord,
                 Proposal)
from .pool import GatherResult, Region, SharedTensorPool, checked_gather
from .space import RING_KERNEL, RING_USER, SpaceEngine
from .table import (
    ENTRY_BYTES,
    HWPID_SHIFT,
    MAX_HWPID,
    PAGE_BYTES,
    PERM_NONE,
    PERM_R,
    PERM_RW,
    PERM_W,
    SUMMARY_TILE,
    CommitInfo,
    HostTable,
    PermissionTable,
    extract_perm,
    make_table,
    pack_ext_addr,
    perm_words_for,
    tenant_permbits,
    tile_summary,
    unpack_ext_addr,
)

__all__ = [k for k in dir() if not k.startswith("_")]
