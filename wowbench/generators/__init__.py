"""Traffic generators, one module each, named by a mix's ``generator``
(see ``wowbench.loadgen``)."""
