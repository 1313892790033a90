"""The plain reference: plain PyTorch, TF32 off, importing nothing of the
port. Each ``<entry>.py`` judges what that entry produced in the window;
``control=True`` puts the reference, computed one precision below the
configuration's fp32, in the program's place."""
