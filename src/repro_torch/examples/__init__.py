"""The reference's two example programs on the port, run as modules:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda]
    PYTHONPATH=src python -m repro_torch.examples.edge_offload_serve [--device cuda]
"""
