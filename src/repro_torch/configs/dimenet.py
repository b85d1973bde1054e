"""dimenet [arXiv:2003.03123]."""
from repro_torch.configs.base import ArchSpec, GNNConfig, GNN_SHAPES

FULL = GNNConfig(
    name="dimenet", n_blocks=6, d_hidden=128, n_bilinear=8,
    n_spherical=7, n_radial=6)

SMOKE = GNNConfig(
    name="dimenet-smoke", n_blocks=2, d_hidden=32, n_bilinear=4,
    n_spherical=4, n_radial=3, dtype="float32")

SPEC = ArchSpec(
    arch_id="dimenet", family="gnn", config=FULL, smoke_config=SMOKE,
    shapes=GNN_SHAPES, source="arXiv:2003.03123",
    notes="directional message passing; triplet gather regime; "
          "non-geometric graphs use synthesized positions (DESIGN.md §5)")
