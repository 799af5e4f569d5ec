"""Configuration (own copy of `ramdsir_tpu/config.py`, same tables and
defaults, plus `device`).

The reference keeps these constants in code: the per-target-domain batch
tables and the dataset defaults (`code/train.py:35-45`, `:616-621`) and the
RAM band fraction L=0.1 (`code/dataset/fundus.py:214`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

# Per-target-domain sub-batch sizes of the source-domain loaders.
FUNDUS_BATCH_LIST: List[List[int]] = [
    [3, 6, 7],
    [2, 7, 7],
    [2, 4, 10],
    [2, 4, 10],
]
PROSTATE_BATCH_LIST: List[List[int]] = [[2] * 5 for _ in range(6)]

FUNDUS_DOMAINS = ["Domain1", "Domain2", "Domain3", "Domain4"]
PROSTATE_DOMAINS = ["Domain1", "Domain2", "Domain3", "Domain4", "Domain5", "Domain6"]
PROSTATE_VOLUME_DOMAINS = ["ISBI", "ISBI_1.5", "I2CVB", "UCL", "BIDMC", "HK"]

DATASET_EPOCHS = {"fundus": 400, "prostate": 200}
DATASET_LR = {"fundus": 2e-3, "prostate": 1e-3}
DATASET_NUM_CLASSES = {"fundus": 2, "prostate": 2}

RAM_L = 0.1  # RAM low-frequency band fraction
CONSISTENCY_WEIGHT = 0.5
DEFAULT_LAMBDA_REC = 0.1
POLY_POWER = 0.9


@dataclasses.dataclass
class TrainConfig:
    """The reference train CLI's options (code/train.py:47-74) and the JAX
    package's extensions, with the JAX package's defaults."""

    data_root: str = "../dataset"
    dataset: str = "fundus"  # {fundus, prostate}
    batch_size: int = 8
    test_batch_size: int = 8
    lr: Optional[float] = None
    epochs: Optional[int] = None
    domain_idxs: Tuple[int, ...] = (0, 1, 2)
    test_domain_idx: int = 3
    in_channels: int = 3
    num_classes: Optional[int] = None
    seed: int = 1337
    lambda_rec: float = DEFAULT_LAMBDA_REC
    deterministic: bool = False
    ram: bool = True
    rec: bool = True
    is_out_domain: bool = False
    consistency: bool = True
    consistency_type: str = "kd"  # {mse, kd}
    save_path: str = "runs/default"
    norm: str = "bn"
    activation: str = "relu"
    image_size: int = 256
    compute_dtype: str = "float32"
    predict_dtype: str = "float32"
    # data-parallel ranks: fit launches them for N > 1 (None and 1: one
    # process); the train CLI's default is every visible CUDA device
    num_devices: Optional[int] = None
    # full-spectrum RAM with the per-step donor FFT (the JAX package's
    # Pallas path); K1 runs in full mode
    ram_use_pallas: bool = False
    # precompute the donor pool's banded amplitudes once per run
    ram_precompute_donor_amp: bool = True
    # banded-DFT RAM: restricted DFT products instead of rfft2/irfft2
    ram_banded_dft: bool = True
    remat: bool = False
    # accepted for parity: TPU layout choices of the same numerics in JAX;
    # the port runs the one fused path whatever they say (train/steps.py)
    fused_dsbn: bool = True
    fused_dual: bool = True
    # accepted for parity; the port always runs the plain topology
    s2d_levels: int = 2
    prefetch: int = 2
    loader: str = "process"
    num_workers: Optional[int] = None
    device_data: bool = True
    # groups steps per dispatch in JAX and never changes results; the port
    # launches each step on its own whatever the value
    scan_window: Optional[int] = None
    # an even split of this batch over the source domains in place of the
    # per-target tables, and (unless lr is given) the LR scaled by its ratio
    # to the table's batch
    global_batch: Optional[int] = None
    log_interval: int = 1
    log_images_every: int = 100
    checkpoint_resume: Optional[str] = None
    trace_dir: Optional[str] = None
    device: str = "cuda"  # torch device of the run
    # the network of the step: "unet" (RAM-DSIR's U-Net, n=16) or a name of
    # models/transunet.CONFIGS ("transunet_r50_b16", TransUNet R50-ViT-B/16);
    # the restoration decoder is RAM-DSIR's either way
    model: str = "unet"

    def resolve(self) -> "TrainConfig":
        cfg = dataclasses.replace(self)
        if cfg.epochs is None:
            cfg.epochs = DATASET_EPOCHS[cfg.dataset]
        if cfg.lr is None:
            cfg.lr = DATASET_LR[cfg.dataset]
            if cfg.global_batch:
                cfg.lr = cfg.lr * cfg.global_batch / sum(self._reference_batch_list())
        if cfg.num_classes is None:
            cfg.num_classes = DATASET_NUM_CLASSES[cfg.dataset]
        if cfg.model != "unet":
            # s2d_levels is the U-Net's TPU layout: a TransUNet's restoration
            # decoder runs without it
            cfg.s2d_levels = 0
        if cfg.ram_use_pallas:
            # the full-spectrum mix consumes the per-step donor images;
            # precomputed banded amplitudes would bypass it
            cfg.ram_precompute_donor_amp = False
        return cfg

    def _reference_batch_list(self) -> List[int]:
        table = FUNDUS_BATCH_LIST if self.dataset == "fundus" else PROSTATE_BATCH_LIST
        return table[self.test_domain_idx][: len(self.domain_idxs)]

    @property
    def batch_size_list(self) -> List[int]:
        if self.global_batch:
            n_dom = len(self.domain_idxs)
            if self.global_batch % n_dom:
                raise ValueError(
                    f"--global_batch {self.global_batch} must divide by the {n_dom} source domains (even split)"
                )
            return [self.global_batch // n_dom] * n_dom
        if self.dataset == "fundus":
            return FUNDUS_BATCH_LIST[self.test_domain_idx]
        return PROSTATE_BATCH_LIST[self.test_domain_idx]

    @property
    def num_domains(self) -> int:
        return len(self.domain_idxs)
