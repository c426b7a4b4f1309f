"""Plain PyTorch references of the benchmark's models, augmentation and
optimiser. They import nothing of the program: each follows the published
description (the paper and torchvision's or timm's code), computes in f32
with TF32 off, and takes its weights and inputs from the benchmark."""
