"""Typed, validated configuration for the framework (the port's copy of
``raydp_tpu/config/config.py``): ``ClusterConfig`` for ``init``,
``DataConfig`` and ``TrainConfig`` for the estimator.

The reference threads untyped string dicts into SparkConf with reserved
magic keys (reference: python/raydp/context.py:55-56,105-110 and
ray_cluster_master.py:146-167 — JSON → JVM system properties). Here
config is dataclasses with validation at construction, plus a single
escape-hatch ``extra`` dict (``init(configs=...)``, and the submit CLI's
``--conf`` through ``RAYDP_TPU_CONF_*``) for forward-compatible knobs.
``TrainConfig.mesh`` is the port's data-parallel
:class:`~raydp_tpu_torch.parallel.MeshSpec`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from raydp_tpu_torch.parallel.mesh import MeshSpec
from raydp_tpu_torch.utils.memory import parse_memory_size

PLACEMENT_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


@dataclass
class ClusterConfig:
    """ETL worker-pool + placement configuration (``raydp_tpu_torch.init``
    arg).

    Mirrors the capability surface of ``raydp.init_spark``
    (reference: python/raydp/context.py:154-205): app name, worker count,
    per-worker cores/memory, placement strategy, free-form configs.
    """

    app_name: str = "raydp-tpu"
    num_workers: int = 2
    cores_per_worker: int = 1
    memory_per_worker: int = 1 * 1024**3  # bytes; str accepted via from_args
    placement_strategy: Optional[str] = None
    placement_group: Optional[Any] = None  # pre-created PlacementGroup
    placement_bundle_indexes: Optional[list] = None
    enable_native: bool = True  # use the C++ data-plane library when built
    # -- elasticity ----------------------------------------------------
    # Crash-respawn budget for ETL workers (reference: executor
    # reschedule on disconnect, RayAppMaster.scala:184-186 + schedule()).
    max_worker_restarts: int = 3
    # -- multi-host ----------------------------------------------------
    num_virtual_nodes: int = 0  # >1: simulate N hosts on this host
    bind_host: str = "127.0.0.1"  # "0.0.0.0" for real cross-host clusters
    advertise_host: Optional[str] = None  # routable addr peers dial
    master_port: int = 0  # fixed AppMaster port (0 = ephemeral); pods
    # joining from other hosts need a known port
    launcher: Optional[Any] = None  # WorkerLauncher; default LocalLauncher
    extra: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_args(
        app_name: str = "raydp-tpu",
        num_workers: int = 2,
        cores_per_worker: int = 1,
        memory_per_worker: "int | str" = "1GB",
        placement_strategy: Optional[str] = None,
        placement_group: Optional[Any] = None,
        placement_bundle_indexes: Optional[list] = None,
        enable_native: bool = True,
        max_worker_restarts: int = 3,
        num_virtual_nodes: int = 0,
        bind_host: str = "127.0.0.1",
        advertise_host: Optional[str] = None,
        master_port: int = 0,
        launcher: Optional[Any] = None,
        configs: Optional[Dict[str, Any]] = None,
    ) -> "ClusterConfig":
        cfg = ClusterConfig(
            app_name=app_name,
            num_workers=num_workers,
            cores_per_worker=cores_per_worker,
            memory_per_worker=parse_memory_size(memory_per_worker),
            placement_strategy=placement_strategy,
            placement_group=placement_group,
            placement_bundle_indexes=placement_bundle_indexes,
            enable_native=enable_native,
            max_worker_restarts=max_worker_restarts,
            num_virtual_nodes=num_virtual_nodes,
            bind_host=bind_host,
            advertise_host=advertise_host,
            master_port=master_port,
            launcher=launcher,
            extra=dict(configs or {}),
        )
        validate_config(cfg)
        return cfg


@dataclass
class DataConfig:
    """Ingest/shard settings for MLDataset and the device loader."""

    batch_size: int = 256
    shuffle: bool = False
    shuffle_seed: Optional[int] = None
    prefetch: int = 2  # host-side chunks staged ahead of the device
    max_rows_per_block: int = 1 << 20
    drop_last: bool = False

    def __post_init__(self):
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if self.prefetch < 0:
            raise ValueError("prefetch must be >= 0")


@dataclass
class TrainConfig:
    """Estimator training-loop settings (pass as ``train_config=`` to
    :class:`~raydp_tpu_torch.train.Estimator`: its values override the
    scalar keyword arguments)."""

    num_epochs: int = 1
    mesh: MeshSpec = field(default_factory=MeshSpec)
    seed: int = 0
    log_every_steps: int = 50
    checkpoint_dir: Optional[str] = None
    # Step-level retry budget (parity with Ray Train's max_retries;
    # reference: python/raydp/torch/estimator.py:269). None = the default
    # budget, inert; setting a value explicitly turns "donation" (here:
    # the in-place update's re-raise) off so the retries happen.
    max_failures: Optional[int] = None
    save_every_steps: int = 0  # >0: mid-epoch checkpoints w/ data position

    def __post_init__(self):
        if self.num_epochs <= 0:
            raise ValueError("num_epochs must be positive")
        if self.save_every_steps < 0:
            raise ValueError("save_every_steps must be >= 0")


def validate_config(cfg: ClusterConfig) -> None:
    if cfg.num_workers < 0:
        raise ValueError("num_workers must be >= 0")
    if cfg.cores_per_worker <= 0:
        raise ValueError("cores_per_worker must be positive")
    if cfg.memory_per_worker <= 0:
        raise ValueError("memory_per_worker must be positive")
    if cfg.placement_strategy is not None:
        if cfg.placement_strategy not in PLACEMENT_STRATEGIES:
            raise ValueError(
                f"placement_strategy must be one of {PLACEMENT_STRATEGIES}, "
                f"got {cfg.placement_strategy!r}"
            )
    if cfg.placement_group is not None and cfg.placement_strategy is not None:
        raise ValueError(
            "pass either a pre-created placement_group or a "
            "placement_strategy, not both"
        )
    if cfg.num_virtual_nodes < 0:
        raise ValueError("num_virtual_nodes must be >= 0")
