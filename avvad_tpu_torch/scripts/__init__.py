"""The command-line entry points (port of the JAX package's ``scripts/``),
each a module with ``main(argv=None)``:

    python -m avvad_tpu_torch.scripts.<name> --help

``import_checkpoint``, ``create_train_files``, ``train``, ``evaluate``,
``run_metrics``, ``reconstruct``, ``export_serving``, ``serve_server`` and
``stream_demo`` take the JAX scripts' flags, but for those that only
configure XLA or Pallas (``--prewarm``, ``--platforms``, ``--pallas-lstm``:
the port's hand-written kernels are always its route on the card), and
add ``--device``: they run on the card unless given ``--device cpu`` and
raise without one. Checkpoints are the port's (``train.checkpoint``); a
reference (PyTorch) checkpoint comes in through ``import_checkpoint``.
"""
