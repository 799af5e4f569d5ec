"""Prostate 3-D volume eval CLI: the JAX package's
`ramdsir_tpu/cli/test_prostate_volume.py` (same flags, same metrics: volume
Dice, HD95 and ASD with the empty-prediction sentinel 100, the CSV log at
`<save path>/../test<N>_log.csv`) plus --device.

NIfTI volumes under <data_dir>/<dataset>/<domain>, min-max to [-1, 1],
3-slice windows, the largest component kept.  BatchNorm adapts to each
window batch's statistics unless --freeze_bn is given.  --model_file is a
`.pth` in the reference's format or a `.ckpt` of the port or of the JAX
package (full or weights-only).

Example (on the card):
  python -m ramdsir_tpu_torch.cli.test_prostate_volume --model_file runs/prostate_t5/final_model.pth \
      --data_dir ../dataset --datasetTest 5 --test_prediction_save_path runs/prostate_t5/eval
"""
from __future__ import annotations

import argparse
import os

from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.train.checkpoint import load_any_checkpoint
from ramdsir_tpu_torch.train.evaluate import append_csv_log, eval_prostate_volumes
from ramdsir_tpu_torch.train.state import build_models
from ramdsir_tpu_torch.train.steps import make_predict_fn
from ramdsir_tpu_torch.utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Test on Prostate dataset (3D volume, PyTorch)")
    p.add_argument("--model_file", type=str, required=True)
    p.add_argument("--dataset", type=str, default="prostate")
    p.add_argument("--data_dir", default="../dataset")
    p.add_argument("--datasetTest", type=int, default=3)
    p.add_argument("--in_channels", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--test_prediction_save_path", type=str, required=True)
    p.add_argument("--save_result", action="store_true")
    p.add_argument("--freeze_bn", action="store_true")
    p.add_argument("--norm", type=str, default="bn")
    p.add_argument("--activation", type=str, default="relu")
    p.add_argument("--device", type=str, default="cuda", help="torch device, e.g. cuda or cpu")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    device = resolve_device(a.device)
    output_path = os.path.join(a.test_prediction_save_path, "test" + str(a.datasetTest))
    os.makedirs(output_path, exist_ok=True)

    cfg = TrainConfig(
        dataset="prostate", in_channels=a.in_channels, num_classes=a.num_classes,
        norm=a.norm, activation=a.activation, rec=False, ram=False,
        save_path=output_path, device=str(device),
    ).resolve()
    models = build_models(cfg)
    load_any_checkpoint(a.model_file, models)
    for m in models.values():
        m.to(device)
    predict = make_predict_fn(cfg, models, bn_adapt=not a.freeze_bn)

    res = eval_prostate_volumes(
        predict, a.data_dir, a.datasetTest,
        batch_size=a.batch_size, with_distances=True, dataset_name=a.dataset,
        save_dir=output_path if a.save_result else None,
    )
    print("\n==>val_dice : %.2f" % (100 * res.dice))
    print("\n==>average_hd : %.2f" % res.hd)
    print("\n==>average_asd : %.2f" % res.asd)
    append_csv_log(
        os.path.join(output_path, "../test" + str(a.datasetTest) + "_log.csv"),
        ["batch-size: ", a.batch_size, a.model_file,
         "dice coefficence: ", res.dice,
         "average_hd: ", res.hd, "average_asd: ", res.asd],
    )
    return res


if __name__ == "__main__":
    main()
