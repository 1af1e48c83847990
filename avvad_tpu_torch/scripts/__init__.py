"""The command-line entry points (port of the JAX package's ``scripts/``),
each a module with ``main(argv=None)``:

    python -m avvad_tpu_torch.scripts.<name> --help

``import_checkpoint``, ``create_train_files``, ``train``, ``evaluate``,
``run_metrics``, ``reconstruct``, ``export_serving``, ``serve_server``,
``stream_demo``, ``visualization_audio`` and ``rehearse_complete`` take the
JAX scripts' flags, but for those that only configure XLA or Pallas
(``--prewarm``, ``--platforms``, ``--pallas-lstm``: the port's hand-written
kernels are always its route on the card), and add ``--device``: they run
on the card unless given ``--device cpu`` and raise without one
(``visualization_audio`` only for ``--check-device-stft``). Checkpoints
are the port's (``train.checkpoint``); a reference (PyTorch) checkpoint
comes in through ``import_checkpoint``.

``visualization_video``, ``visualization_video_upsampling``,
``compare_predictions``, ``summarize_training``, ``synth_noisy_testset`` and
``synth_complete_corpus`` read and write files on the host only and take
the JAX scripts' flags as they are. The figures (``run_metrics --figures``,
``visualization_audio``, ``visualization_video_upsampling --figures``) need
matplotlib and ``visualization_video`` needs cv2, imported when they run:
where the package is missing they raise an ``ImportError`` that names it.
"""
