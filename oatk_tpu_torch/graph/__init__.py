from .asmg import Asmg
