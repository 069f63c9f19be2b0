"""Offline dataset preprocessing: a raw voice directory -> the training
layout that ``train_sambert`` and ``train_hifigan`` read (counterpart of
``kantts_tpu/bin/process_data.py``).

    python -m kantts_tpu_torch.bin.process_data --voice_input_dir V \\
        --voice_output_dir D --audio_config C [--se_model M] [--device cpu]

The text front-end (``prosody/prosody.txt``, or byte mode from
``text/text.txt``), FP augmentation when the prosody carries FP annotation,
the audio feature pipeline, speaker embeddings when the audio config sets
``se_feature``, then the vocoder and acoustic train/valid metafiles (with
the ``fpadd``/``fprm`` variants). The mel, energy and D-TDNN work runs on
``--device``: the card unless told ``cpu``; pitch runs on the host.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Optional

from kantts_tpu_torch.data.dataset import AMDataset, VocDataset
from kantts_tpu_torch.preprocess.audio_processor import AudioProcessor
from kantts_tpu_torch.preprocess.fp_processor import FpProcessor, is_fp_line
from kantts_tpu_torch.preprocess.script_convertor import TextScriptConvertor
from kantts_tpu_torch.utils.config import dump_yaml, load_yaml, stamp_config
from kantts_tpu_torch.utils.device import resolve_device
from kantts_tpu_torch.utils.log import log_to_file


def gen_metafile(voice_output_dir: str, fp_enable: bool = False, badlist=None,
                 split_ratio: float = 0.98) -> None:
    """Vocoder and acoustic train/valid splits, each kept where it exists."""
    voc_train = os.path.join(voice_output_dir, "train.lst")
    voc_valid = os.path.join(voice_output_dir, "valid.lst")
    if not (os.path.exists(voc_train) and os.path.exists(voc_valid)):
        VocDataset.gen_metafile(os.path.join(voice_output_dir, "wav"),
                                voice_output_dir, split_ratio)
        logging.info("Voc metafile generated.")

    raw_metafile = os.path.join(voice_output_dir, "raw_metafile.txt")
    am_train = os.path.join(voice_output_dir, "am_train.lst")
    am_valid = os.path.join(voice_output_dir, "am_valid.lst")
    if not (os.path.exists(am_train) and os.path.exists(am_valid)):
        AMDataset.gen_metafile(raw_metafile, voice_output_dir, am_train,
                               am_valid, badlist, split_ratio)
        logging.info("AM metafile generated.")

    if fp_enable:
        for variant in ("fpadd", "fprm"):
            meta = os.path.join(voice_output_dir, f"{variant}_metafile.txt")
            train = os.path.join(voice_output_dir, f"am_{variant}_train.lst")
            valid = os.path.join(voice_output_dir, f"am_{variant}_valid.lst")
            if not (os.path.exists(train) and os.path.exists(valid)):
                AMDataset.gen_metafile(meta, voice_output_dir, train, valid,
                                       badlist, split_ratio)
                logging.info("AM %s metafile generated.", variant)


def process_data(voice_input_dir: str, voice_output_dir: str,
                 audio_config: str, speaker_name: Optional[str] = None,
                 target_lang: str = "PinYin", skip_script: bool = False,
                 se_model: Optional[str] = None, device="cuda") -> None:
    """Logs the badlist and the wall seconds of each stage: the audio
    processor's, then ``speaker_embedding`` (SE voices) and ``metafiles``."""
    device = resolve_device(device)
    foreign_lang = "EnUS"
    os.makedirs(voice_output_dir, exist_ok=True)

    emo_tag_path = os.path.join(voice_input_dir, "emotion_tag.txt")
    if not os.path.exists(emo_tag_path):
        emo_tag_path = None

    plain_text_dir = os.path.join(voice_input_dir, "text")
    if speaker_name is None:
        speaker_name = os.path.basename(os.path.normpath(voice_input_dir))

    config = stamp_config(load_yaml(audio_config))
    se_enable = config["audio_config"].get("se_feature", False)
    dump_yaml(config, os.path.join(voice_output_dir, "audio_config.yaml"))

    fp_enable = False
    raw_metafile = None
    prosody = None
    if skip_script:
        logging.info("Skip script conversion")
    else:
        raw_metafile = os.path.join(voice_output_dir, "raw_metafile.txt")
        if os.path.exists(plain_text_dir):
            TextScriptConvertor.turn_text_into_bytes(
                os.path.join(plain_text_dir, "text.txt"), raw_metafile,
                speaker_name,
            )
        else:
            tsc = TextScriptConvertor(target_lang, foreign_lang, emo_tag_path,
                                      speaker_name)
            prosody = os.path.join(voice_input_dir, "prosody", "prosody.txt")
            tsc.process(
                prosody,
                os.path.join(voice_output_dir, "Script.xml"),
                raw_metafile,
            )
            with open(prosody, encoding="utf-8") as f:
                lines = f.readlines()
            fp_enable = len(lines) > 1 and is_fp_line(lines[1])

    if fp_enable:
        FpProcessor().process(voice_output_dir, prosody, raw_metafile)
        logging.info("Processing fp done.")

    ap = AudioProcessor(config["audio_config"], device)
    ap.process(voice_input_dir, voice_output_dir, raw_metafile)
    seconds = dict(ap.stage_seconds)
    logging.info("Processing audio done.")

    if se_enable:
        from kantts_tpu_torch.preprocess.se_processor import SpeakerEmbeddingProcessor

        t0 = time.perf_counter()
        SpeakerEmbeddingProcessor(device=device).process(voice_output_dir, se_model)
        seconds["speaker_embedding"] = time.perf_counter() - t0
        logging.info("Processing speaker embedding done.")

    t0 = time.perf_counter()
    gen_metafile(voice_output_dir, fp_enable, ap.badcase_list)
    seconds["metafiles"] = time.perf_counter() - t0
    logging.info("Badlist: %s", " ".join(ap.badcase_list))
    logging.info("Stage seconds: %s", " ".join(
        f"{name}={s:.3f}" for name, s in seconds.items()))
    logging.info("Processing done.")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Dataset preprocessor")
    parser.add_argument("--voice_input_dir", type=str, required=True)
    parser.add_argument("--voice_output_dir", type=str, required=True)
    parser.add_argument("--audio_config", type=str, required=True)
    parser.add_argument("--speaker", type=str, default=None)
    parser.add_argument("--lang", type=str, default="PinYin")
    parser.add_argument("--se_model", type=str, default=None)
    parser.add_argument("--skip_script", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="where the mel, energy and D-TDNN work runs: "
                             "cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(
        format="%(asctime)s, %(levelname)-4s [%(filename)s:%(lineno)d] %(message)s",
        datefmt="%Y-%m-%d:%H:%M:%S", level=logging.INFO)
    os.makedirs(args.voice_output_dir, exist_ok=True)
    with log_to_file(os.path.join(args.voice_output_dir,
                                  "data_process_stdout.log")):
        process_data(args.voice_input_dir, args.voice_output_dir,
                     args.audio_config, args.speaker, args.lang,
                     args.skip_script, args.se_model, args.device)


if __name__ == "__main__":
    main()
