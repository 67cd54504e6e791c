"""Fully supervised train + Viterbi-test entry point
(mucon_tpu/cli/train_test_mucon_full.py): `train_test_mucon` with the
fully supervised model and dataset (ground-truth frame labels and segment
lengths in the loss).

    python -m mucon_tpu_torch.cli.train_test_mucon_full \
        --cfg my.yaml --set dataset.split 1 --exp-name my_exp
"""

from mucon_tpu_torch.cli.train_test_mucon import main as _main


def main(argv=None):
    return _main(argv, supervision="full")


if __name__ == "__main__":
    main()
