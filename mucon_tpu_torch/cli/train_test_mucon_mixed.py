"""Mixed-supervision train + Viterbi-test entry point
(mucon_tpu/cli/train_test_mucon_mixed.py): `train_test_mucon` with the
mixed model and dataset, where `dataset.mixed.full_supervision_percentage`
of the training videos are fully supervised:

    python -m mucon_tpu_torch.cli.train_test_mucon_mixed \
        --set dataset.mixed.full_supervision_percentage 25.0
"""

from mucon_tpu_torch.cli.train_test_mucon import main as _main


def main(argv=None):
    return _main(argv, supervision="mixed")


if __name__ == "__main__":
    main()
