"""Launchers: the serving, training and tuning CLIs and their dispatcher
(``python -m repro_torch.launch {tune,serve}``), the paper-table launcher,
meshes and sharding rules, step builders, the multi-pod dry run, step and
kernel timing."""
