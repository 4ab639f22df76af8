"""Streaming ASR service main (ref: src/v2-asrbin/v2-asr-service.cc:
``asr-service --config=conf.txt <nnet> <graph> <words.txt>``)."""

from __future__ import annotations

import sys

from asr_decoder_tpu.cli._model import build_info, register_info_flags
from asr_decoder_tpu.serving.server import AsrServer, SocketConfig
from asr_decoder_tpu.utils.config import ConfigOptions
from asr_decoder_tpu.utils.device import enable_compile_cache


def main(argv: list[str] | None = None) -> int:
    opts = ConfigOptions(
        usage="serve [options] <nnet-binary> <graph> <words.txt>")
    sock = SocketConfig()
    sock.register(opts)
    dec, online, fbank, am, extra = register_info_flags(opts)
    pos = opts.parse(sys.argv[1:] if argv is None else argv)
    enable_compile_cache()
    if len(pos) != 3:
        print(opts.usage(), file=sys.stderr)
        return 2
    info = build_info(pos[0], pos[1], pos[2], dec, online, fbank, am, extra)
    import asyncio
    asyncio.run(AsrServer(info, sock).serve_forever())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
