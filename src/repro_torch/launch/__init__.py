"""Launchers of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, ``--distributed`` under
``torchrun``), the mesh builders (``launch.mesh``), the input stand-ins
(``launch.input_specs``) and the launch search spaces (``launch.spaces``)."""
