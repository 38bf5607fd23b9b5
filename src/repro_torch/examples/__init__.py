"""The reference's example scripts as modules of the port:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.serve_batch [--device cpu]
    python -m repro_torch.examples.offload_paper_pipeline [--device cpu]

Each runs on ``cuda`` unless given ``--device``; its ``main(argv)``
prints what the reference script prints and returns the same results
as plain Python values."""
