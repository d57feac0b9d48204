"""The analysis, stage by stage, in plain PyTorch: what each output of a
request should be.

  pose     frames and person boxes -> keypoints (tracked or single-peak
           decode) and the secondary-mode features
  heads    keypoints -> phase logits (GCN) and error logits (error head)
  compare  keypoints against a reference swing -> embeddings, soft-DTW
           cost, hard-DTW table; the error head again on the reference
           warped along a path

The stages after the pose take keypoints as arguments, so the check can
hand them the system's own keypoints and judge each stage alone.
"""

from __future__ import annotations

import torch

from benchmark.reference import align, decode, nets, pose_reference


class Reference:
    """`conf`: the configuration file (its "pipeline" section states the
    sizes, its "pose_reference" names the pose net's module); `state`:
    {model: state_dict}; `lowp`: the control's lower precision (nets.Numerics)."""

    def __init__(self, conf: dict, state: dict, device, lowp: bool = False):
        self.c = stated = conf["pipeline"]
        num = nets.Numerics(lowp)
        self.pose_net = pose_reference(conf).PoseNet(stated["pose"], num)
        self.gcn = nets.GCN(stated["gcn"], num)
        self.encoder = nets.AlignEncoder(stated["align"], num)
        self.error = nets.ErrorHead(stated["error"], num)
        for name, m in (("pose", self.pose_net), ("gcn", self.gcn), ("align", self.encoder),
                        ("error", self.error)):
            m.load_state_dict(state[name])
            m.to(device).eval()

    @torch.no_grad()
    def pose(self, frames: torch.Tensor, boxes: torch.Tensor):
        """frames [N, T, H, W, 3] uint8, boxes [N, T, 4] -> keypoints [N, T, V, 3]
        (image px, score) and aux [N, T, V, 4] (None without mode features),
        in blocks of `frame_batch` frames."""
        p, c = self.c["pose"], self.c
        N, T = frames.shape[:2]
        V, k = p["num_joints"], p["decode_tracking"]
        cs = decode.center_scale(boxes.float(), p["input_hw"][1] / p["input_hw"][0])
        flat_f = frames.reshape(N * T, *frames.shape[2:])
        flat_b = cs.reshape(N * T, 4)
        mb = max(1, min(c["frame_batch"], N * T))
        decs = []
        for s in range(0, N * T, mb):
            hm = self.pose_net(decode.crops(flat_f[s:s + mb], flat_b[s:s + mb], p["input_hw"]))
            decs.append(decode.topk_modes(hm, k, p["track_suppress_radius"]) if k
                        else decode.decode_single(hm))
        dec = torch.cat(decs)
        if not k:
            kpts = decode.to_image(dec, flat_b, p["heatmap_hw"], p["input_hw"])
            return kpts.reshape(N, T, V, 3), None
        img = decode.to_image(dec.reshape(N * T, V * k, 3), flat_b, p["heatmap_hw"],
                              p["input_hw"]).reshape(N, T, V, k, 3)
        # The track runs in image px over the clip-mean crop scale.
        s = (cs[..., 3].mean(1) / p["heatmap_hw"][0])[:, None, None, None]
        norm = torch.cat([img[..., :2] / s[..., None], img[..., 2:]], dim=-1)
        tr = decode.viterbi(norm.transpose(0, 1), p["track_lambda"]).transpose(0, 1)
        kpts = torch.cat([tr[..., :2] * s, tr[..., 2:]], dim=-1)
        if not c["error"]["mode_features"]:
            return kpts, None
        return kpts, decode.secondary_modes(img, kpts)

    @torch.no_grad()
    def heads(self, kpts: torch.Tensor, aux, valid: torch.Tensor):
        """-> (phase logits [N, T, P], error logits [N, E] without a reference)."""
        logits = self.gcn(nets.normalize_skeleton(kpts, valid), valid)
        return logits, self.error(kpts, logits, valid, None, aux)

    @torch.no_grad()
    def compare(self, kpts, valid, ref_kpts, ref_valid):
        """-> (D [N, T, Tr], soft-DTW cost [N], hard-DTW table [N, T, Tr], la, lb)."""
        ea = self.encoder(nets.normalize_skeleton(kpts, valid), valid)
        er = self.encoder(nets.normalize_skeleton(ref_kpts[None], ref_valid[None]),
                          ref_valid[None])
        D = align.pairwise_sqdist(ea, er.expand(ea.shape[0], *er.shape[1:]))
        N = D.shape[0]
        la = valid.sum(-1).clamp(min=1).long()
        lb = ref_valid.sum().clamp(min=1).long().expand(N)
        idx = torch.arange(N, device=D.device)
        soft = align.dtw_table(D, self.c["align"]["gamma"])[idx, la - 1, lb - 1]
        return D, soft, align.dtw_table(D, 0.0), la, lb

    @torch.no_grad()
    def refined_error(self, kpts, phase_logits, valid, ref_kpts, path, length, aux):
        """The error head with the reference warped onto each clip along `path`."""
        warped = align.warp(ref_kpts, path, length, kpts.shape[1])
        return self.error(kpts, phase_logits, valid, warped, aux)
