"""Model FLOPs of each configuration at a unit's shapes: 2 m n k for every
matrix product of the model, element-wise work and gathers left out.
A module per configuration, named as it is."""
