"""Command-line tools of the port: ``train_cas``, ``test_cas``, ``vis_cas``
(``python -m srcgan_tpu_torch.cli.<name>``).  Each runs on the card unless
``--device cpu`` is given."""
