from kantts_tpu_torch.serve.server import make_http_server, wav_bytes  # noqa: F401
from kantts_tpu_torch.serve.service import TTSService  # noqa: F401
