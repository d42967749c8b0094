"""Sharding of the port: logical-axis rules over a torch.distributed device
mesh, DTensor placements and activation constraints."""
