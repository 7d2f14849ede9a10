"""The reference's example programs on the port, run as modules:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda]
    PYTHONPATH=src python -m repro_torch.examples.edge_offload_serve [--device cuda]
    PYTHONPATH=src python -m repro_torch.examples.fleet_sim
    PYTHONPATH=src python -m repro_torch.examples.llm_edge_decode [--device cuda]
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cuda]

``fleet_sim`` touches no card: the fleet is host code.
"""
