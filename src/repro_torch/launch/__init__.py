"""Meshes, batch shapes and the train / serve launchers
(``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.serve``)."""
