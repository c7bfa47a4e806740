"""Offline preprocessing CLI: GIFTI metric files -> patched .npy splits::

    python -m surface_vision_transformers_tpu_torch.cli.preprocess \
        configs/preprocessing/dhcp.yml [--set resolution.sub_ico=1 ...]

Runs ``data.preprocess.run`` on the host (numpy; no device) and prints its
dict (split, shape, output_folder, n_subjects).
"""

from surface_vision_transformers_tpu_torch.cli._common import parse_config


def main(argv=None) -> None:
    raw = parse_config("GIFTI -> patched .npy preprocessing", argv, with_device=False)
    from surface_vision_transformers_tpu_torch.data import preprocess

    print(preprocess.run(raw))


if __name__ == "__main__":
    main()
