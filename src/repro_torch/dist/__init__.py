"""Distribution layer of the port: logical-axis sharding rules onto
DTensor placements (``sharding.py``) and hand-scheduled collectives
(``collectives.py``), both over ``torch.distributed``."""
