"""Command-line tools of the port: ``train_cas``, ``test_cas``, ``vis_cas``,
``train_cyclegan``, ``test_cyclegan``, ``train_multitask`` and
``prepare_data`` (``python -m srcgan_tpu_torch.cli.<name>``).  Each tool that
computes runs on the card unless ``--device cpu`` is given."""
