"""Emotion category inventory (33 entries) in KAN-TTS's vocabulary order (a
copy of ``kantts_tpu/text/emotion_types.py``) — order matters because ids
feed the emotion embedding table."""

EMOTION_TYPES = [
    "emotion_none",
    "emotion_neutral",
    "emotion_angry",
    "emotion_disgust",
    "emotion_fear",
    "emotion_happy",
    "emotion_sad",
    "emotion_surprise",
    "emotion_calm",
    "emotion_gentle",
    "emotion_relax",
    "emotion_lyrical",
    "emotion_serious",
    "emotion_disgruntled",
    "emotion_satisfied",
    "emotion_disappointed",
    "emotion_excited",
    "emotion_anxiety",
    "emotion_jealousy",
    "emotion_hate",
    "emotion_pity",
    "emotion_pleasure",
    "emotion_arousal",
    "emotion_dominance",
] + [f"emotion_placeholder{i}" for i in range(1, 10)]
