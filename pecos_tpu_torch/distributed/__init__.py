"""Multi-node training: tree-partitioned XR-Linear over the host comm layer
(the port of ``pecos_tpu/distributed``)."""
