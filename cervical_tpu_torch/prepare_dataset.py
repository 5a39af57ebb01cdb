"""Dataset preparation CLI — the port's counterpart of
``scripts/prepare_dataset.py``: labelbox masks -> gray class ids, splits,
the offline 8x augmentation, the label audit (replaces the reference's
``labelbox(aug).py`` / ``voc_annotation.py`` notebooks).

Stages (pick any subset; they run in this order):
  --ndjson export.ndjson [--api_key KEY --masks_dir masks/]
                                                     parse (+ fetch) masks
  --colors_dir masks/ --gray_dir SegmentationClass/  color -> class ids
  --split_root VOCdevkit [--ratios 8,1,1 --seed 0]   write split txts
  --augment_root VOCdevkit --augment_out VOCdevkit_aug   8x offline aug
  --audit VOCdevkit                                  label format audit

Usage:
    python -m cervical_tpu_torch.prepare_dataset --split_root VOCdevkit \
        --ratios 8,1,1

Host-only (PIL and numpy): no stage runs on the card.  The mask fetch
(``--api_key``) is the one network call.
"""

from __future__ import annotations

import os
import sys


def main(argv):
    from cervical_tpu_torch.config import parse_cli_overrides
    from cervical_tpu_torch.data import splits as S
    from cervical_tpu_torch.data.voc import read_split
    from cervical_tpu_torch.tools import labelbox as LB
    from cervical_tpu_torch.tools import offline_aug as OA
    from cervical_tpu_torch.tools import voc_annotation as VA

    args = parse_cli_overrides(argv)

    if "ndjson" in args:
        class_urls, _, ids, _ = LB.parse_ndjson(args["ndjson"])
        print(f"{len(ids)} images, {len(class_urls)} annotation masks")
        if "api_key" in args and "masks_dir" in args:
            LB.build_color_masks(class_urls,
                                 LB.default_fetch_fn(args["api_key"]),
                                 args["masks_dir"])
            print(f"wrote color masks to {args['masks_dir']}")

    if "colors_dir" in args:
        out = LB.colors_to_gray(args["colors_dir"], args["gray_dir"])
        print(f"converted {len(out)} masks to class ids")

    if "split_root" in args:
        ratios = [float(x) for x in str(args.get("ratios", "8,1,1")).split(",")]
        total = sum(ratios)
        seg = os.path.join(args["split_root"], "VOC2007", "SegmentationClass")
        ids = [f[:-4] for f in sorted(os.listdir(seg)) if f.endswith(".png")]
        train, val, test = S.ratio_split(
            ids, tuple(r / total for r in ratios), seed=int(args.get("seed", 0)))
        sets = os.path.join(args["split_root"], "VOC2007", "ImageSets",
                            "Segmentation")
        for name, id_list in (("train", train), ("val", val), ("test", test)):
            OA.write_split_ids(sorted(id_list), os.path.join(sets, name + ".txt"))
        print(f"splits: train {len(train)} / val {len(val)} / test {len(test)}")

    if "augment_root" in args:
        root, out = args["augment_root"], args["augment_out"]
        train_ids = read_split(root, "train")
        ids = train_ids + read_split(root, "val")
        new_ids = OA.write_seg_augmented(root, out, ids,
                                         seed=int(args.get("seed", 0)))
        # 8x-expanded train/val splits in the new layout
        n_train = len(train_ids) * 8
        sets = os.path.join(out, "VOC2007", "ImageSets", "Segmentation")
        OA.write_split_ids(new_ids[:n_train], os.path.join(sets, "train.txt"))
        OA.write_split_ids(new_ids[n_train:], os.path.join(sets, "val.txt"))
        print(f"augmented {len(ids)} -> {len(new_ids)} images in {out}")

    if "audit" in args:
        counts, warnings = VA.audit_labels(args["audit"])
        occupied = {int(i): int(c) for i, c in enumerate(counts) if c}
        print(f"label histogram: {occupied}")
        for w in warnings:
            print("WARNING:", w)


if __name__ == "__main__":
    main(sys.argv[1:])
