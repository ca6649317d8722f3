"""Train a segmentation net from Python instead of the annonet_train CLI.

The library pieces compose exactly like the reference's internals
(annonet_train_main.cpp:260-644): scan -> pipeline -> trainer -> artifact.

Run:  python examples/train_library.py <anno_dataset_dir> <out_model.npz>
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])  # repo root, if not installed


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__)
        return 1
    dataset_dir, out_path = sys.argv[1], sys.argv[2]

    from annonet_jax import serialization
    from annonet_jax.classes import parse_anno_classes
    from annonet_jax.data.crop import CropOptions
    from annonet_jax.data.dataset import (
        find_image_files,
        read_anno_classes_file,
    )
    from annonet_jax.data.pipeline import CropPipeline
    from annonet_jax.models.segnet import (
        SegNetConfig,
        recommended_input_dimension,
        required_input_dimension,
    )
    from annonet_jax.train.trainer import Trainer, TrainerConfig

    files = find_image_files(dataset_dir, require_ground_truth=True)
    classes_json = read_anno_classes_file(dataset_dir)
    anno_classes = parse_anno_classes(classes_json)

    model_config = SegNetConfig(
        class_count=len(anno_classes), level_count=2, base_width=16
    )
    # crop size keys off the computed receptive field, like the CLI
    # (annonet_train_main.cpp:376-383)
    dim = recommended_input_dimension(
        model_config, 2 * required_input_dimension(model_config)
    )
    crop_options = CropOptions(
        dim=dim, allow_flip_left_right=True, allow_flip_upside_down=True
    )
    trainer = Trainer(model_config, TrainerConfig(), seed=0)

    with CropPipeline(
        files, anno_classes, crop_options, thread_count=4, seed=1
    ) as pipe:
        for step in range(200):
            images, labels = pipe.next_minibatch(16)
            loss = trainer.train_step_crops(images, labels, crop_options)
            if step % 20 == 0:
                print(f"step {step}: loss {loss:.4f}")

    serialization.save_model(
        out_path,
        trainer.runtime_net(),  # BN-folded inference params
        model_config,
        classes_json,
        downscaling_factor=1.0,
    )
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
