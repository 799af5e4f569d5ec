"""Fundus 2-D slice eval CLI: the JAX package's
`ramdsir_tpu/cli/test_fundus_slice.py` (same flags, same metrics: cup/disc
Dice, HD95 and ASD with the empty-prediction sentinel 100, the CSV log at
`<save path>/../test<N>_log.csv`) plus --device.

BatchNorm adapts to each test batch's statistics unless --freeze_bn is
given.  --model_file is a `.pth` in the reference's format or a `.ckpt`
of the port or of the JAX package (full or weights-only).

Example (on the card):
  python -m ramdsir_tpu_torch.cli.test_fundus_slice --model_file runs/fundus_t3/final_model.pth \
      --data_dir ../dataset --datasetTest 3 --test_prediction_save_path runs/fundus_t3/eval
"""
from __future__ import annotations

import argparse
import os

from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.train.checkpoint import load_any_checkpoint
from ramdsir_tpu_torch.train.evaluate import append_csv_log, eval_fundus
from ramdsir_tpu_torch.train.state import build_models
from ramdsir_tpu_torch.train.steps import make_predict_fn
from ramdsir_tpu_torch.utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Test on Fundus dataset (2D slice, PyTorch)")
    p.add_argument("--model_file", type=str, required=True)
    p.add_argument("--dataset", type=str, default="fundus")
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
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda", help="torch device, e.g. cuda or cpu")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    device = resolve_device(a.device)
    output_path = os.path.join(a.test_prediction_save_path, "test" + str(a.datasetTest))
    os.makedirs(output_path, exist_ok=True)

    cfg = TrainConfig(
        dataset="fundus", in_channels=a.in_channels, num_classes=a.num_classes,
        norm=a.norm, activation=a.activation, rec=False, ram=False,
        image_size=a.image_size, save_path=output_path, device=str(device),
    ).resolve()
    models = build_models(cfg)
    load_any_checkpoint(a.model_file, models)
    for m in models.values():
        m.to(device)
    predict = make_predict_fn(cfg, models, bn_adapt=not a.freeze_bn)

    res = eval_fundus(
        predict, a.data_dir, a.datasetTest,
        batch_size=a.batch_size, image_size=a.image_size,
        with_distances=True, dataset_name=a.dataset,
        save_dir=output_path if a.save_result else None,
    )
    print("\n==>val_cup_dice : %.2f" % (100 * res.cup_dice))
    print("\n==>val_disc_dice : %.2f" % (100 * res.disc_dice))
    print("\n==>average_hd_OC : %.2f" % res.hd_oc)
    print("\n==>average_hd_OD : %.2f" % res.hd_od)
    print("\n==>average_asd_OC : %.2f" % res.asd_oc)
    print("\n==>average_asd_OD : %.2f" % res.asd_od)
    append_csv_log(
        os.path.join(output_path, "../test" + str(a.datasetTest) + "_log.csv"),
        ["batch-size: ", a.batch_size, a.model_file,
         "cup dice coefficence: ", res.cup_dice,
         "disc dice coefficence: ", res.disc_dice,
         "average_hd_OC: ", res.hd_oc, "average_hd_OD: ", res.hd_od,
         "average_asd_OC: ", res.asd_oc, "average_asd_OD: ", res.asd_od],
    )
    return res


if __name__ == "__main__":
    main()
