"""Entry points of the port (mirror mucon_tpu/cli): `train_test_mucon`
(and its `_full` / `_mixed` regimes), `test_mucon`, `predict`,
`export_model` and `inspect_run`, each run as
`python -m mucon_tpu_torch.cli.<name>`."""
