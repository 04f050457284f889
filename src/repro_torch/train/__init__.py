from .loop import LoopConfig, LoopState, resume, run_loop
