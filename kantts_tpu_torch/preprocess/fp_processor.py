"""Filled-pause metafile augmentation (a copy of
``kantts_tpu/preprocess/fp_processor.py``): derives FP labels from prosody
annotation lines (FP/I/N/Q), writes ``fpadd_metafile.txt`` (filler
syllables tagged emotion_disgust) and ``fprm_metafile.txt`` (fillers
removed). This is the FP corpus format that ``data/dataset.py`` reads.
"""

from __future__ import annotations

import logging
import os
import random
from typing import Dict, List

FP_CATEGORIES = ("FP", "I", "N", "Q")


def is_fp_line(line: str) -> bool:
    return all(e in FP_CATEGORIES for e in line.strip().split(" "))


class FpProcessor:
    def addfp(self, voice_output_dir: str, prosody: str,
              raw_metafile_lines: List[str]) -> str:
        with open(prosody, encoding="utf-8") as f:
            prosody_lines = f.readlines()

        # collect per-utterance FP label sequences from the annotation block
        fp_label_dict: Dict[str, List[str]] = {}
        idx_name = ""
        i = 0
        while i < len(prosody_lines):
            if len(prosody_lines[i].strip().split("\t")) == 2:
                idx_name = prosody_lines[i].strip().split("\t")[0]
                i += 1
                continue
            if is_fp_line(prosody_lines[i]):
                fp = prosody_lines[i].strip().split("\t")[0].split(" ")
                i += 4
            else:
                # unannotated pron line: every syllable is a plain 'N'
                n = len(
                    prosody_lines[i].strip().split("\t")[0]
                    .replace("/ ", "").replace(". ", "").split(" ")
                )
                fp = ["N"] * n
                i += 1
            fp_label_dict[idx_name] = fp

        fpadd_metafile = os.path.join(voice_output_dir, "fpadd_metafile.txt")
        with open(fpadd_metafile, "w", encoding="utf-8") as f_out:
            for line in raw_metafile_lines:
                tokens = line.strip().split("\t")
                if len(tokens) != 2:
                    continue
                uttname, symbol_str = tokens
                labels = fp_label_dict.get(uttname)
                if labels is None:
                    logging.warning("%s has no FP annotation", uttname)
                    continue
                out_tokens = []
                idx = 0
                for symbol in symbol_str.split(" "):
                    emotion = symbol.split("$")[4]
                    symbol = symbol.replace(emotion, "emotion_neutral")
                    if idx < len(labels):
                        if labels[idx] == "FP" and "none" not in symbol:
                            symbol = symbol.replace("emotion_neutral",
                                                    "emotion_disgust")
                        if symbol.split("$")[2] in ("s_both", "s_end"):
                            idx += 1
                    out_tokens.append(symbol)
                f_out.write(uttname + "\t" + " ".join(out_tokens) + "\n")
        return fpadd_metafile

    def removefp(self, voice_output_dir: str, fpadd_metafile: str,
                 raw_metafile_lines: List[str]) -> str:
        with open(fpadd_metafile, encoding="utf-8") as f:
            fpadd_lines = f.readlines()

        fprm_metafile = os.path.join(voice_output_dir, "fprm_metafile.txt")
        with open(fprm_metafile, "w", encoding="utf-8") as f_out:
            for raw_line, fpadd_line in zip(raw_metafile_lines, fpadd_lines):
                tokens = raw_line.strip().split("\t")
                symbols = tokens[1].split(" ")
                fpadd_symbols = fpadd_line.strip().split("\t")[1].split(" ")
                out_tokens = []
                idx = 0
                while idx < len(symbols):
                    if "$emotion_disgust" in fpadd_symbols[idx]:
                        # skip the filler and its trailing break token
                        if idx + 1 < len(symbols) and "none" in fpadd_symbols[idx + 1]:
                            idx += 2
                        else:
                            idx += 1
                        continue
                    out_tokens.append(symbols[idx])
                    idx += 1
                f_out.write(tokens[0] + "\t" + " ".join(out_tokens) + "\n")
        return fprm_metafile

    def process(self, voice_output_dir: str, prosody: str,
                raw_metafile: str) -> None:
        with open(raw_metafile, encoding="utf-8") as f:
            lines = f.readlines()
        random.shuffle(lines)
        fpadd = self.addfp(voice_output_dir, prosody, lines)
        self.removefp(voice_output_dir, fpadd, lines)
