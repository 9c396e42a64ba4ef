// vjp_full's tile loop with x̄ factored through row sums, for
// studies/vjp_variants.py, which builds csrc/vjp_full.cu with
// -DNB_VJP_FULL_FACTORED -Istudies (this takes that file's Sums, kRows,
// kTile and kUnroll):
//   sum_j t = m_k sum_j w A_j - A_k sum_j w m_j - sum_j 3 w5 (d.g) d,
// so a pair forms neither g nor t (about 8 FP32 instructions fewer).  It
// brings back the row-sum cancellation the pair-by-pair t avoids (m_k sum w
// A_j and A_k sum w m_j are each as large as a heavy body or a smooth
// cotangent makes them), so it is held to the f64 gates, not to bits.
template <bool kNormal, bool kDiag>
__device__ __forceinline__ void tile_sums(const float4* tp, const float4* ta, const float4 (&me)[kRows],
                                          const float3 (&ak)[kRows], const int (&self)[kRows], float eps2,
                                          Sums (&tot)[kRows]) {
    float wax[kRows], way[kRows], waz[kRows], wm[kRows], cx[kRows], cy[kRows], cz[kRows], mb[kRows], ph[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) wax[r] = way[r] = waz[r] = wm[r] = cx[r] = cy[r] = cz[r] = mb[r] = ph[r] = 0.f;
#pragma unroll (kUnroll)
    for (int j = 0; j < kTile; ++j) {
        const float4 s = tp[j];
        const float4 a = ta[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (kDiag && j == self[r]) continue;
            const float dx = s.x - me[r].x;
            const float dy = s.y - me[r].y;
            const float dz = s.z - me[r].z;
            const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
            const float rr = kNormal ? rsqrt_normal(d2) : rsqrtf(d2);
            const float inv = rr * rr;
            const float w = inv * rr;
            const float w5 = w * inv;
            const float p = fmaf(dx, a.x, fmaf(dy, a.y, dz * a.z));
            const float q = fmaf(dx, ak[r].x, fmaf(dy, ak[r].y, dz * ak[r].z));
            const float dg = fmaf(me[r].w, p, -(s.w * q));
            const float c = 3.f * w5 * dg;
            const float wmj = w * s.w;
            wax[r] = fmaf(w, a.x, wax[r]);
            way[r] = fmaf(w, a.y, way[r]);
            waz[r] = fmaf(w, a.z, waz[r]);
            wm[r] += wmj;
            cx[r] = fmaf(c, dx, cx[r]);
            cy[r] = fmaf(c, dy, cy[r]);
            cz[r] = fmaf(c, dz, cz[r]);
            mb[r] = fmaf(-w, p, mb[r]);
            ph[r] = fmaf(wmj, q, ph[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        tot[r].x += fmaf(me[r].w, wax[r], -fmaf(ak[r].x, wm[r], cx[r]));
        tot[r].y += fmaf(me[r].w, way[r], -fmaf(ak[r].y, wm[r], cy[r]));
        tot[r].z += fmaf(me[r].w, waz[r], -fmaf(ak[r].z, wm[r], cz[r]));
        tot[r].m += mb[r];
        tot[r].phi += ph[r];
    }
}
