"""Entry points: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, and the planning tools
``dryrun``, ``report`` and ``quant_roofline`` (with ``mesh``,
``roofline`` and ``op_cost``)."""
