"""The frozen yardstick: each kernel's operations and bytes, one file a
kernel, copied from the port's cost definitions as they stood when the
benchmark was written; each model's FLOPs a round, one file a model;
the card's peaks. Nothing here imports the port: a later change to a
kernel cannot move the bound it is measured against."""
