"""Multi-process runtime (counterpart of ``mgwfbp_tpu/runtime/``): the
agreement primitives the trainer's resilience layer uses
(``coordination``). The supervisor, liveness and elastic resize are ROADMAP
Queue 1 item 4."""
