"""Command-line entry points (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.dryrun``, ``python -m repro_torch.launch.summarize``,
``python -m repro_torch.launch.inject_tables``) and the meshes they build
(``mesh.py``)."""
