"""The plain reference the port is held to: plain PyTorch, float32 by
default, written from the project's published semantics (the reference
app's rayTracer.cl and the soft renderer's formulas), imports nothing of the
port and takes nothing the port has made. It runs in blocks of rows so that
1080p and 4K frames fit on one card."""
