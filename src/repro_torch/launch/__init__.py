"""Entry points: ``python -m repro_torch.launch.serve``, ``.train`` and
``.dryrun``; ``mesh`` describes the production mesh."""
