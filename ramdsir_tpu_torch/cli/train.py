"""Train CLI: the JAX package's flags (`ramdsir_tpu/cli/train.py`) plus
--device.  A flag whose feature is not ported yet raises
NotImplementedError naming its ROADMAP.md item.

Examples (RAM-DSIR on the card; fundus target domain 3, prostate target 5
with the five other domains as sources, each evaluated every epoch):
  python -m ramdsir_tpu_torch.cli.train --dataset fundus --domain_idxs 0,1,2 \
      --test_domain_idx 3 --ram --rec --is_out_domain --consistency \
      --consistency_type kd --save_path runs/fundus_t3
  python -m ramdsir_tpu_torch.cli.train --dataset prostate --domain_idxs 0,1,2,3,4 \
      --test_domain_idx 5 --ram --rec --consistency --consistency_type kd \
      --save_path runs/prostate_t5
--compute_dtype bfloat16 runs the U-Net in bfloat16 (float32 master
weights, RAM in float32).  --resume runs/fundus_t3/final_model.ckpt goes on
from a full-state checkpoint of the port or of the JAX package.
"""
from __future__ import annotations

import argparse

from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.train.loop import fit


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DG Medical Segmentation Train (PyTorch)")
    p.add_argument("--data_root", type=str, default="../dataset")
    p.add_argument("--dataset", type=str, default="fundus", choices=["fundus", "prostate"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--test_batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--domain_idxs", type=str, default="0,1,2")
    p.add_argument("--test_domain_idx", type=int, default=3)
    p.add_argument("--in_channels", type=int, default=3)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--lambda_rec", type=float, default=0.1)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--ram", action="store_true")
    p.add_argument("--rec", action="store_true")
    p.add_argument("--is_out_domain", action="store_true")
    p.add_argument("--consistency", action="store_true")
    p.add_argument("--consistency_type", type=str, default="mse", choices=["mse", "kd"])
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--norm", type=str, default="bn")
    p.add_argument("--activation", type=str, default="relu")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--ram_use_pallas", action="store_true",
                   help="full-spectrum RAM with the per-step donor FFT (K1 full mode)")
    p.add_argument("--no_ram_banded_dft", action="store_true",
                   help="rfft2/irfft2 RAM instead of the banded restricted-DFT products")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--max_steps", type=int, default=None, help="smoke-run cap")
    p.add_argument("--trace_dir", type=str, default=None)
    p.add_argument("--scan_window", type=int, default=None,
                   help="accepted and recorded; the port dispatches step by step")
    p.add_argument("--global_batch", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda", help="torch device, e.g. cuda or cpu")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    cfg = TrainConfig(
        data_root=a.data_root,
        dataset=a.dataset,
        batch_size=a.batch_size,
        test_batch_size=a.test_batch_size,
        lr=a.lr,
        epochs=a.epochs,
        domain_idxs=tuple(int(x) for x in a.domain_idxs.split(",")),
        test_domain_idx=a.test_domain_idx,
        in_channels=a.in_channels,
        num_classes=a.num_classes,
        seed=a.seed,
        lambda_rec=a.lambda_rec,
        deterministic=a.deterministic,
        ram=a.ram,
        rec=a.rec,
        is_out_domain=a.is_out_domain,
        consistency=a.consistency,
        consistency_type=a.consistency_type,
        save_path=a.save_path,
        norm=a.norm,
        activation=a.activation,
        image_size=a.image_size,
        compute_dtype=a.compute_dtype,
        num_devices=a.num_devices,
        ram_use_pallas=a.ram_use_pallas,
        ram_banded_dft=not a.no_ram_banded_dft,
        remat=a.remat,
        checkpoint_resume=a.resume,
        trace_dir=a.trace_dir,
        scan_window=a.scan_window,
        global_batch=a.global_batch,
        device=a.device,
    )
    summary = fit(cfg, max_steps=a.max_steps)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
