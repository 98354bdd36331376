"""Paper-experiment model configs (the CNN5 and the compact ResNet)."""
