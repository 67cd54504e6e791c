"""Dataset layer: the disk contract and per-video samples
(mucon_tpu/data/general_dataset.py; the weakly supervised dataset only).

Disk contract (the reference's src/core/datasets/general_dataset.py:93-101
and README.md:24-47): a dataset root containing

    features/<name>.npy     [T x D] float      pre-extracted I3D features
    labels/<name>.npy       [T]     int        framewise ground truth
    transcripts/<name>.npy  [N]     int        ordered action transcript
    lengths/<name>.npy      [N]     float      per-action lengths (supervised)
    split{1..4}.{train,test}                   newline file lists
    mapping.txt                                "<id> <name>" per line

Samples are host-side numpy; `data/batching.py` pads them into batches
with length masks instead of the reference's batch-size-1 collate.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from mucon_tpu_torch.data.utils import create_tf_input, create_tf_target
from mucon_tpu_torch.decode.grammar import ModifiedPathGrammar


@dataclass
class Sample:
    """One video (reference `Batch`, general_dataset.py:17-34, minus the
    bs=1 leading axis — batching happens in the padded collator)."""

    feats: np.ndarray  # [T x D] float32
    gt_label: np.ndarray  # [T] int64
    transcript: np.ndarray  # [N] int64
    transcript_tf_input: np.ndarray  # [N + 1] int64 (SOS + transcript)
    transcript_tf_target: np.ndarray  # [N + 1] int64 (transcript + EOS)
    video_name: str


class GeneralDataset:
    """npy-backed dataset with SOS/EOS vocab handling.

    Reference: general_dataset.py:46-173.
    """

    def __init__(
        self,
        cfg,
        root: Path,
        relative_path_to_list="split1.train",
        relative_path_to_mapping="mapping.txt",
        feat_dim: int = -1,
        relative_path_to_train_list=None,
    ):
        self.cfg = cfg
        self.root = Path(root)
        self.file_list = self.root / relative_path_to_list
        train_file_list = (
            self.root / relative_path_to_train_list
            if relative_path_to_train_list is not None
            else None
        )
        self.mapping_file = self.root / relative_path_to_mapping
        self.end_class_id = 0
        self.mof_eval_ignore_classes: List[int] = []
        self.background_class_ids: List[int] = [0]

        self.feat_dim = feat_dim
        self.convenient_name: Optional[str] = None
        self.split = -1
        self.max_transcript_length = 100

        with open(self.file_list) as f:
            self.file_names = [x.strip() for x in f if len(x.strip()) > 0]

        self.action_id_to_name: Dict[int, str] = {}
        self.action_name_to_id: Dict[str, int] = {}
        with open(self.mapping_file) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) == 2:
                    i, name = parts
                    self.action_id_to_name[int(i)] = name
                    self.action_name_to_id[name] = int(i)

        self.num_actions = len(self.action_id_to_name)

        self.feat_file_paths = [
            self.root / "features" / f"{x}.npy" for x in self.file_names
        ]
        self.gt_file_paths = [
            self.root / "labels" / f"{x}.npy" for x in self.file_names
        ]
        self.tr_file_paths = [
            self.root / "transcripts" / f"{x}.npy" for x in self.file_names
        ]

        # decoder vocabulary: EOS = M, SOS = M + 1 (general_dataset.py:103-110)
        self.eos_token = "_EOS_"
        self.sos_token = "_SOS_"
        self.eos_token_id = self.num_actions
        self.sos_token_id = self.num_actions + 1
        self.action_id_to_name[self.eos_token_id] = self.eos_token
        self.action_name_to_id[self.eos_token] = self.eos_token_id
        self.action_id_to_name[self.sos_token_id] = self.sos_token
        self.action_name_to_id[self.sos_token] = self.sos_token_id

        # all training transcripts -> path grammar for full decoding
        # (general_dataset.py:112-130)
        self.training_transcripts_list: List[List[int]] = []
        self.training_path_grammar: Optional[ModifiedPathGrammar] = None
        if train_file_list is not None:
            with open(train_file_list) as f:
                train_names = [x.strip() for x in f if len(x.strip()) > 0]
            seen = set()
            for name in train_names:
                t = tuple(np.load(str(self.root / "transcripts" / f"{name}.npy")))
                seen.add(t)
            self.training_transcripts_list = [list(t) for t in seen]
            self.training_path_grammar = ModifiedPathGrammar(
                transcripts=self.training_transcripts_list,
                num_classes=self.num_actions,
            )

    def get_num_classes(self) -> int:
        return self.num_actions

    def __len__(self) -> int:
        return len(self.feat_file_paths)

    def num_frames(self, item: int) -> int:
        """Frame count without loading features (mmap header read only)."""
        arr = np.load(str(self.feat_file_paths[item]), mmap_mode="r")
        return arr.shape[0]

    def __getitem__(self, item: int) -> Sample:
        feats = np.load(str(self.feat_file_paths[item])).astype(np.float32)
        gt_labels = np.load(str(self.gt_file_paths[item])).astype(np.int64)
        transcript = np.load(str(self.tr_file_paths[item])).astype(np.int64)

        return Sample(
            feats=feats,
            gt_label=gt_labels,
            transcript=transcript,
            transcript_tf_input=create_tf_input(transcript, sos_i=self.sos_token_id),
            transcript_tf_target=create_tf_target(
                transcript, eos_i=self.eos_token_id
            ),
            video_name=self.file_names[item],
        )
