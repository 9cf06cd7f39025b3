// trajio: trajectory files for jamun_tpu_torch (the port's own copy of the
// JAX package's `native/trajio/trajio.cpp`; the same codec, byte for byte).
//
//   - CHARMM/NAMD DCD read/write (fortran-record binary)
//   - GROMACS XTC read/write with the full xdr3dfcoord integer compression
//     scheme (the magicints table, mixed-radix encode/decodeints, adaptive
//     smallidx with sticky run lengths, the water-molecule atom swap).
//
// Built by `jamun_tpu_torch/data/build_native.py` with g++ at first use into
// `jamun_tpu_torch/_build/`, bound with ctypes by
// `jamun_tpu_torch/data/_native_io.py`. Coordinates are nm.

#include <cstdio>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

// ---------------------------------------------------------------- DCD ------

bool write_record(FILE* f, const void* data, int32_t n) {
    return fwrite(&n, 4, 1, f) == 1 && fwrite(data, 1, (size_t)n, f) == (size_t)n &&
           fwrite(&n, 4, 1, f) == 1;
}

bool read_record(FILE* f, std::vector<char>& buf) {
    int32_t n = 0;
    if (fread(&n, 4, 1, f) != 1 || n < 0 || n > (1 << 30)) return false;
    buf.resize(n);
    if (n && fread(buf.data(), 1, (size_t)n, f) != (size_t)n) return false;
    int32_t n2 = 0;
    if (fread(&n2, 4, 1, f) != 1 || n2 != n) return false;
    return true;
}

struct DcdInfo {
    int n_frames = 0;
    int n_atoms = 0;
    bool has_unitcell = false;
    long frame0_offset = 0;
};

bool dcd_parse_header(FILE* f, DcdInfo* info) {
    std::vector<char> buf;
    if (!read_record(f, buf) || buf.size() < 84 || memcmp(buf.data(), "CORD", 4) != 0)
        return false;
    int32_t charmm = 0, cell_flag = 0;
    memcpy(&charmm, buf.data() + 80, 4);
    memcpy(&cell_flag, buf.data() + 44, 4);
    info->has_unitcell = charmm != 0 && cell_flag != 0;
    if (!read_record(f, buf)) return false;  // titles
    if (!read_record(f, buf) || buf.size() < 4) return false;
    memcpy(&info->n_atoms, buf.data(), 4);
    info->frame0_offset = ftell(f);
    // count frames
    int frames = 0;
    std::vector<char> tmp;
    while (true) {
        if (info->has_unitcell && !read_record(f, tmp)) break;
        if (!read_record(f, tmp)) break;
        if (!read_record(f, tmp)) break;
        if (!read_record(f, tmp)) break;
        frames++;
    }
    info->n_frames = frames;
    fseek(f, info->frame0_offset, SEEK_SET);
    return true;
}

// ---------------------------------------------------------------- XDR ------

// XDR is big-endian; x86 is little-endian.
inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }

struct XdrWriter {
    FILE* f;
    bool ok = true;
    void put_i32(int32_t v) {
        uint32_t b = bswap32((uint32_t)v);
        ok &= fwrite(&b, 4, 1, f) == 1;
    }
    void put_f32(float v) {
        uint32_t u;
        memcpy(&u, &v, 4);
        u = bswap32(u);
        ok &= fwrite(&u, 4, 1, f) == 1;
    }
    void put_opaque(const uint8_t* data, int n) {
        put_i32(n);
        ok &= fwrite(data, 1, (size_t)n, f) == (size_t)n;
        int pad = (4 - (n % 4)) % 4;
        uint8_t zeros[4] = {0, 0, 0, 0};
        if (pad) ok &= fwrite(zeros, 1, (size_t)pad, f) == (size_t)pad;
    }
};

struct XdrReader {
    FILE* f;
    bool ok = true;
    int32_t get_i32() {
        uint32_t b = 0;
        ok &= fread(&b, 4, 1, f) == 1;
        return (int32_t)bswap32(b);
    }
    float get_f32() {
        uint32_t b = 0;
        ok &= fread(&b, 4, 1, f) == 1;
        b = bswap32(b);
        float v;
        memcpy(&v, &b, 4);
        return v;
    }
    bool get_opaque(std::vector<uint8_t>& out) {
        int32_t n = get_i32();
        if (!ok || n < 0 || n > (1 << 30)) return false;
        out.resize(n);
        if (n && fread(out.data(), 1, (size_t)n, f) != (size_t)n) return false;
        int pad = (4 - (n % 4)) % 4;
        uint8_t tmp[4];
        if (pad && fread(tmp, 1, (size_t)pad, f) != (size_t)pad) return false;
        return true;
    }
};

// -------------------------------------------------- 3dfcoord compression ---

// The GROMACS xdr3dfcoord magicints table, reproduced VERBATIM (several
// entries deviate from round(2^(i/3)) — e.g. 5060, 524287, 8388607 — and
// these historical values are part of the wire format; computing the table
// from the formula breaks interop).
static const int kMagicInts[73] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290,
    1625, 2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384,
    20642, 26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072,
    165140, 208063, 262144, 330280, 416127, 524287, 660561, 832255,
    1048576, 1321122, 1664510, 2097152, 2642245, 3329021, 4194304,
    5284491, 6658042, 8388607, 10568983, 13316085, 16777216};
const int kFirstIdx = 9;
const int kLastIdx = 72;  // last valid index into kMagicInts

struct BitWriter {
    std::vector<uint8_t> buf;
    uint32_t acc = 0;
    int nbits = 0;  // bits currently in acc (MSB-first stream)
    void put(uint32_t value, int bits) {
        // append `bits` LSBs of value, MSB-first into the stream
        for (int b = bits - 1; b >= 0; b--) {
            acc = (acc << 1) | ((value >> b) & 1u);
            nbits++;
            if (nbits == 8) {
                buf.push_back((uint8_t)acc);
                acc = 0;
                nbits = 0;
            }
        }
    }
    void put_big(const uint32_t* vals, const int* bits, int n) {
        for (int i = 0; i < n; i++) put(vals[i], bits[i]);
    }
    void flush() {
        if (nbits) {
            buf.push_back((uint8_t)(acc << (8 - nbits)));
            acc = 0;
            nbits = 0;
        }
    }
};

struct BitReader {
    const uint8_t* buf;
    size_t len, pos = 0;
    int bit = 0;
    bool ok = true;
    uint32_t get(int bits) {
        uint32_t v = 0;
        for (int b = 0; b < bits; b++) {
            if (pos >= len) {
                ok = false;
                return v;
            }
            v = (v << 1) | ((buf[pos] >> (7 - bit)) & 1u);
            bit++;
            if (bit == 8) {
                bit = 0;
                pos++;
            }
        }
        return v;
    }
};

// xdrfile's sizeofint: smallest n with 2^n > size (note: STRICTLY greater —
// one more bit than minimal when size is a power of two; wire-format exact).
inline int sizeofint(int size) {
    unsigned int num = 1;
    int num_of_bits = 0;
    while (size >= (int)num && num_of_bits < 32) {
        num_of_bits++;
        num <<= 1;
    }
    return num_of_bits;
}

// xdrfile's sizeofints: bits for the little-endian mixed-radix packing of
// num_of_ints values with the given sizes.
inline int sizeofints(int num_of_ints, const uint32_t sizes[]) {
    uint32_t bytes[32];
    uint32_t num_of_bytes = 1, bytecnt = 0, tmp;
    int num_of_bits = 0;
    bytes[0] = 1;
    for (int i = 0; i < num_of_ints; i++) {
        tmp = 0;
        for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
            tmp = bytes[bytecnt] * sizes[i] + tmp;
            bytes[bytecnt] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = tmp & 0xff;
            tmp >>= 8;
        }
        num_of_bytes = bytecnt;
    }
    uint32_t num = 1;
    num_of_bytes--;
    while (bytes[num_of_bytes] >= num) {
        num_of_bits++;
        num *= 2;
    }
    return num_of_bits + (int)num_of_bytes * 8;
}

// xdrfile's sendints: mixed-radix big-number encode, bytes LSB-first.
inline void encodeints(BitWriter& bw, int num_of_ints, int num_of_bits,
                       const uint32_t sizes[], const uint32_t nums[]) {
    uint32_t bytes[32];
    int num_of_bytes = 0;
    uint32_t tmp = nums[0];
    do {
        bytes[num_of_bytes++] = tmp & 0xff;
        tmp >>= 8;
    } while (tmp != 0);
    for (int i = 1; i < num_of_ints; i++) {
        int bytecnt;
        tmp = nums[i];
        for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
            tmp = bytes[bytecnt] * sizes[i] + tmp;
            bytes[bytecnt] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = tmp & 0xff;
            tmp >>= 8;
        }
        num_of_bytes = bytecnt;
    }
    if (num_of_bits >= num_of_bytes * 8) {
        for (int i = 0; i < num_of_bytes; i++) bw.put(bytes[i], 8);
        bw.put(0, num_of_bits - num_of_bytes * 8);
    } else {
        int i;
        for (i = 0; i < num_of_bytes - 1; i++) bw.put(bytes[i], 8);
        bw.put(bytes[i], num_of_bits - (num_of_bytes - 1) * 8);
    }
}

// xdrfile's receiveints.
inline void decodeints(BitReader& br, int num_of_ints, int num_of_bits,
                       const uint32_t sizes[], int32_t nums[]) {
    int bytes[32];
    int num_of_bytes = 0;
    bytes[0] = bytes[1] = bytes[2] = bytes[3] = 0;
    while (num_of_bits > 8) {
        bytes[num_of_bytes++] = (int)br.get(8);
        num_of_bits -= 8;
    }
    if (num_of_bits > 0) bytes[num_of_bytes++] = (int)br.get(num_of_bits);
    for (int i = num_of_ints - 1; i > 0; i--) {
        int num = 0;
        for (int j = num_of_bytes - 1; j >= 0; j--) {
            num = (num << 8) | bytes[j];
            int p = num / (int)sizes[i];
            bytes[j] = p;
            num = num - p * (int)sizes[i];
        }
        nums[i] = num;
    }
    nums[0] = bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) | (bytes[3] << 24);
}

// Encode one frame of coordinates (nm) with the given precision, following
// GROMACS xdr3dfcoord EXACTLY (xdrfile's compressed-coordinate wire format):
//   natoms; [natoms <= 9: plain floats]; precision(float); minint[3];
//   maxint[3]; smallidx; opaque(bitstream).
// Bitstream per block: absolute triple (mixed-radix over the min/max range),
// 1-bit flag; flag=1 => 5-bit (run*3 + is_smaller+1) with sticky run
// semantics, then run/3 small-diff triples (mixed-radix, smallidx bits each,
// adaptive via is_smaller); includes the water-molecule first/second atom
// swap. Returns false on coordinate overflow.
bool encode_frame(XdrWriter& w, const float* xyz, int natoms, float precision) {
    w.put_i32(natoms);
    if (natoms <= 9) {
        for (int k = 0; k < natoms * 3; k++) w.put_f32(xyz[k]);
        return true;
    }
    w.put_f32(precision);

    const float MAXABS = (float)(INT32_MAX - 2);
    std::vector<int32_t> ip(natoms * 3);
    int32_t minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
    int32_t maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
    int mindiff = INT32_MAX;
    int32_t oldl[3] = {0, 0, 0};
    for (int i = 0; i < natoms; i++) {
        int32_t l[3];
        for (int d = 0; d < 3; d++) {
            float v = xyz[i * 3 + d] * precision;
            if (std::fabs(v) > MAXABS) return false;
            l[d] = (int32_t)(v >= 0 ? v + 0.5f : v - 0.5f);  // round half away from 0
            minint[d] = std::min(minint[d], l[d]);
            maxint[d] = std::max(maxint[d], l[d]);
            ip[i * 3 + d] = l[d];
        }
        int diff = std::abs(l[0] - oldl[0]) + std::abs(l[1] - oldl[1]) + std::abs(l[2] - oldl[2]);
        if (diff < mindiff && i > 0) mindiff = diff;
        oldl[0] = l[0];
        oldl[1] = l[1];
        oldl[2] = l[2];
    }
    for (int d = 0; d < 3; d++) w.put_i32(minint[d]);
    for (int d = 0; d < 3; d++) w.put_i32(maxint[d]);
    if ((float)(maxint[0] - minint[0]) >= MAXABS || (float)(maxint[1] - minint[1]) >= MAXABS ||
        (float)(maxint[2] - minint[2]) >= MAXABS)
        return false;

    uint32_t sizeint[3] = {(uint32_t)(maxint[0] - minint[0] + 1),
                           (uint32_t)(maxint[1] - minint[1] + 1),
                           (uint32_t)(maxint[2] - minint[2] + 1)};
    int bitsizeint[3] = {0, 0, 0};
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        bitsizeint[0] = sizeofint((int)sizeint[0]);
        bitsizeint[1] = sizeofint((int)sizeint[1]);
        bitsizeint[2] = sizeofint((int)sizeint[2]);
        bitsize = 0;  // flag the use of large sizes
    } else {
        bitsize = sizeofints(3, sizeint);
    }

    int smallidx = kFirstIdx;
    while (smallidx < kLastIdx && kMagicInts[smallidx] < mindiff) smallidx++;
    w.put_i32(smallidx);

    int maxidx = std::min(kLastIdx, smallidx + 8);
    int minidx = maxidx - 8;
    int smaller = kMagicInts[std::max(kFirstIdx, smallidx - 1)] / 2;
    int smallnum = kMagicInts[smallidx] / 2;
    uint32_t sizesmall[3];
    sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)kMagicInts[smallidx];
    int larger = kMagicInts[maxidx] / 2;

    BitWriter bw;
    int prevrun = -1;
    int prevcoord[3] = {0, 0, 0};
    uint32_t tmpcoord[30];
    int i = 0;
    while (i < natoms) {
        bool is_small = false;
        int32_t* thiscoord = &ip[(size_t)i * 3];
        int is_smaller;
        if (smallidx < maxidx && i >= 1 && std::abs(thiscoord[0] - prevcoord[0]) < larger &&
            std::abs(thiscoord[1] - prevcoord[1]) < larger &&
            std::abs(thiscoord[2] - prevcoord[2]) < larger) {
            is_smaller = 1;
        } else if (smallidx > minidx) {
            is_smaller = -1;
        } else {
            is_smaller = 0;
        }
        if (i + 1 < natoms) {
            if (std::abs(thiscoord[0] - thiscoord[3]) < smallnum &&
                std::abs(thiscoord[1] - thiscoord[4]) < smallnum &&
                std::abs(thiscoord[2] - thiscoord[5]) < smallnum) {
                // interchange first with second atom (water-molecule trick)
                std::swap(thiscoord[0], thiscoord[3]);
                std::swap(thiscoord[1], thiscoord[4]);
                std::swap(thiscoord[2], thiscoord[5]);
                is_small = true;
            }
        }
        uint32_t abs3[3] = {(uint32_t)(thiscoord[0] - minint[0]),
                            (uint32_t)(thiscoord[1] - minint[1]),
                            (uint32_t)(thiscoord[2] - minint[2])};
        if (bitsize == 0) {
            bw.put(abs3[0], bitsizeint[0]);
            bw.put(abs3[1], bitsizeint[1]);
            bw.put(abs3[2], bitsizeint[2]);
        } else {
            encodeints(bw, 3, bitsize, sizeint, abs3);
        }
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];
        thiscoord += 3;
        i++;

        int run = 0;
        if (!is_small && is_smaller == -1) is_smaller = 0;
        while (is_small && run < 8 * 3) {
            if (is_smaller == -1 &&
                ((int64_t)(thiscoord[0] - prevcoord[0]) * (thiscoord[0] - prevcoord[0]) +
                     (int64_t)(thiscoord[1] - prevcoord[1]) * (thiscoord[1] - prevcoord[1]) +
                     (int64_t)(thiscoord[2] - prevcoord[2]) * (thiscoord[2] - prevcoord[2]) >=
                 (int64_t)smaller * smaller)) {
                is_smaller = 0;  // none of the remaining diffs may hinder shrinking
            }
            tmpcoord[run++] = (uint32_t)(thiscoord[0] - prevcoord[0] + smallnum);
            tmpcoord[run++] = (uint32_t)(thiscoord[1] - prevcoord[1] + smallnum);
            tmpcoord[run++] = (uint32_t)(thiscoord[2] - prevcoord[2] + smallnum);
            prevcoord[0] = thiscoord[0];
            prevcoord[1] = thiscoord[1];
            prevcoord[2] = thiscoord[2];
            i++;
            thiscoord += 3;
            is_small = false;
            if (i < natoms && std::abs(thiscoord[0] - prevcoord[0]) < smallnum &&
                std::abs(thiscoord[1] - prevcoord[1]) < smallnum &&
                std::abs(thiscoord[2] - prevcoord[2]) < smallnum) {
                is_small = true;
            }
        }
        if (run != prevrun || is_smaller != 0) {
            prevrun = run;
            bw.put(1, 1);
            bw.put((uint32_t)(run + is_smaller + 1), 5);
        } else {
            bw.put(0, 1);
        }
        for (int k = 0; k < run; k += 3) {
            encodeints(bw, 3, smallidx, sizesmall, &tmpcoord[k]);
        }
        if (is_smaller != 0) {
            smallidx += is_smaller;
            if (is_smaller < 0) {
                smallnum = smaller;
                smaller = smallidx > kFirstIdx ? kMagicInts[smallidx - 1] / 2 : 0;
            } else {
                smaller = smallnum;
                smallnum = kMagicInts[smallidx] / 2;
            }
            sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)kMagicInts[smallidx];
        }
    }
    bw.flush();
    w.put_opaque(bw.buf.data(), (int)bw.buf.size());
    return true;
}

bool decode_frame(XdrReader& r, std::vector<float>& out, int* natoms_out) {
    int natoms = r.get_i32();
    if (!r.ok || natoms <= 0 || natoms > (1 << 24)) return false;
    *natoms_out = natoms;
    out.resize((size_t)natoms * 3);
    if (natoms <= 9) {
        for (int k = 0; k < natoms * 3; k++) out[k] = r.get_f32();
        return r.ok;
    }
    float precision = r.get_f32();
    int32_t minint[3], maxint[3];
    for (int d = 0; d < 3; d++) minint[d] = r.get_i32();
    for (int d = 0; d < 3; d++) maxint[d] = r.get_i32();

    uint32_t sizeint[3] = {(uint32_t)(maxint[0] - minint[0] + 1),
                           (uint32_t)(maxint[1] - minint[1] + 1),
                           (uint32_t)(maxint[2] - minint[2] + 1)};
    int bitsizeint[3] = {0, 0, 0};
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        bitsizeint[0] = sizeofint((int)sizeint[0]);
        bitsizeint[1] = sizeofint((int)sizeint[1]);
        bitsizeint[2] = sizeofint((int)sizeint[2]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(3, sizeint);
    }

    int smallidx = r.get_i32();
    if (!r.ok || smallidx < kFirstIdx || smallidx > kLastIdx) return false;
    int smaller = kMagicInts[std::max(kFirstIdx, smallidx - 1)] / 2;
    int smallnum = kMagicInts[smallidx] / 2;
    uint32_t sizesmall[3];
    sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)kMagicInts[smallidx];

    std::vector<uint8_t> stream;
    if (!r.get_opaque(stream)) return false;
    BitReader br{stream.data(), stream.size()};

    float inv_precision = 1.0f / precision;
    int run = 0;
    int i = 0;
    size_t o = 0;
    int32_t prevcoord[3] = {0, 0, 0};
    int32_t thiscoord[3];
    while (i < natoms && br.ok) {
        if (bitsize == 0) {
            thiscoord[0] = (int32_t)br.get(bitsizeint[0]);
            thiscoord[1] = (int32_t)br.get(bitsizeint[1]);
            thiscoord[2] = (int32_t)br.get(bitsizeint[2]);
        } else {
            decodeints(br, 3, bitsize, sizeint, thiscoord);
        }
        i++;
        thiscoord[0] += minint[0];
        thiscoord[1] += minint[1];
        thiscoord[2] += minint[2];
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];

        uint32_t flag = br.get(1);
        int is_smaller = 0;
        if (flag == 1) {
            run = (int)br.get(5);
            is_smaller = run % 3;
            run -= is_smaller;
            is_smaller--;
        }
        if (run > 0) {
            for (int k = 0; k < run; k += 3) {
                // A corrupt stream can claim a run longer than the atoms
                // remaining; bound both the atom counter and the output
                // cursor before decoding/writing (heap-OOB hardening,
                // mirrors GROMACS xdrfile).
                if (i >= natoms || o + (k == 0 ? 6u : 3u) > (size_t)natoms * 3)
                    return false;
                decodeints(br, 3, smallidx, sizesmall, thiscoord);
                i++;
                thiscoord[0] += prevcoord[0] - smallnum;
                thiscoord[1] += prevcoord[1] - smallnum;
                thiscoord[2] += prevcoord[2] - smallnum;
                if (k == 0) {
                    // interchange first with second atom (water-molecule
                    // trick): write the delta-decoded atom first
                    std::swap(thiscoord[0], prevcoord[0]);
                    std::swap(thiscoord[1], prevcoord[1]);
                    std::swap(thiscoord[2], prevcoord[2]);
                    out[o++] = (float)prevcoord[0] * inv_precision;
                    out[o++] = (float)prevcoord[1] * inv_precision;
                    out[o++] = (float)prevcoord[2] * inv_precision;
                } else {
                    prevcoord[0] = thiscoord[0];
                    prevcoord[1] = thiscoord[1];
                    prevcoord[2] = thiscoord[2];
                }
                out[o++] = (float)thiscoord[0] * inv_precision;
                out[o++] = (float)thiscoord[1] * inv_precision;
                out[o++] = (float)thiscoord[2] * inv_precision;
            }
        } else {
            out[o++] = (float)thiscoord[0] * inv_precision;
            out[o++] = (float)thiscoord[1] * inv_precision;
            out[o++] = (float)thiscoord[2] * inv_precision;
        }
        smallidx += is_smaller;
        if (smallidx < kFirstIdx || smallidx > kLastIdx) return false;
        if (is_smaller < 0) {
            smallnum = smaller;
            smaller = smallidx > kFirstIdx ? kMagicInts[smallidx - 1] / 2 : 0;
        } else if (is_smaller > 0) {
            smaller = smallnum;
            smallnum = kMagicInts[smallidx] / 2;
        }
        sizesmall[0] = sizesmall[1] = sizesmall[2] = (uint32_t)kMagicInts[smallidx];
    }
    return br.ok && i == natoms && o == (size_t)natoms * 3;
}

const int kXtcMagic = 1995;

}  // namespace

extern "C" {

// ------------------------------------------------------------- DCD API -----

int trajio_dcd_info(const char* path, int* n_frames, int* n_atoms) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    DcdInfo info;
    bool ok = dcd_parse_header(f, &info);
    fclose(f);
    if (!ok) return -2;
    *n_frames = info.n_frames;
    *n_atoms = info.n_atoms;
    return 0;
}

// out: [n_frames * n_atoms * 3] floats in nm (file stores Angstrom)
int trajio_dcd_read(const char* path, float* out, int max_frames) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    DcdInfo info;
    if (!dcd_parse_header(f, &info)) {
        fclose(f);
        return -2;
    }
    int frames = std::min(info.n_frames, max_frames);
    std::vector<char> bx, by, bz, cell;
    for (int fr = 0; fr < frames; fr++) {
        if (info.has_unitcell && !read_record(f, cell)) break;
        if (!read_record(f, bx) || !read_record(f, by) || !read_record(f, bz)) break;
        const float* X = (const float*)bx.data();
        const float* Y = (const float*)by.data();
        const float* Z = (const float*)bz.data();
        float* o = out + (size_t)fr * info.n_atoms * 3;
        for (int a = 0; a < info.n_atoms; a++) {
            o[a * 3 + 0] = X[a] * 0.1f;
            o[a * 3 + 1] = Y[a] * 0.1f;
            o[a * 3 + 2] = Z[a] * 0.1f;
        }
    }
    fclose(f);
    return frames;
}

int trajio_dcd_write(const char* path, const float* pos_nm, int n_frames, int n_atoms) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    // header
    std::vector<char> hdr(84, 0);
    memcpy(hdr.data(), "CORD", 4);
    int32_t nset = n_frames, one = 1, charmm = 24;
    memcpy(hdr.data() + 4, &nset, 4);
    memcpy(hdr.data() + 12, &one, 4);
    memcpy(hdr.data() + 80, &charmm, 4);
    write_record(f, hdr.data(), 84);
    std::vector<char> title(4 + 80, 0);
    int32_t ntitle = 1;
    memcpy(title.data(), &ntitle, 4);
    memcpy(title.data() + 4, "Created by jamun-tpu trajio", 27);
    write_record(f, title.data(), (int)title.size());
    write_record(f, &n_atoms, 4);
    std::vector<float> axis(n_atoms);
    for (int fr = 0; fr < n_frames; fr++) {
        const float* p = pos_nm + (size_t)fr * n_atoms * 3;
        for (int d = 0; d < 3; d++) {
            for (int a = 0; a < n_atoms; a++) axis[a] = p[a * 3 + d] * 10.0f;
            write_record(f, axis.data(), n_atoms * 4);
        }
    }
    fclose(f);
    return 0;
}

// ------------------------------------------------------------- XTC API -----

int trajio_xtc_info(const char* path, int* n_frames, int* n_atoms) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    XdrReader r{f};
    int frames = 0, natoms = 0;
    while (true) {
        long start = ftell(f);
        int magic = r.get_i32();
        if (!r.ok) break;
        if (magic != kXtcMagic) {
            fclose(f);
            return -2;
        }
        natoms = r.get_i32();
        r.get_i32();  // step
        r.get_f32();  // time
        for (int k = 0; k < 9; k++) r.get_f32();  // box
        std::vector<float> tmp;
        int na = 0;
        XdrReader r2{f};
        if (!decode_frame(r2, tmp, &na)) {
            fclose(f);
            return frames > 0 ? frames : -3;
        }
        (void)start;
        frames++;
    }
    fclose(f);
    *n_frames = frames;
    *n_atoms = natoms;
    return 0;
}

int trajio_xtc_read(const char* path, float* out, int max_frames) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int frames = 0;
    while (frames < max_frames) {
        XdrReader r{f};
        int magic = r.get_i32();
        if (!r.ok) break;
        if (magic != kXtcMagic) {
            fclose(f);
            return -2;
        }
        int natoms = r.get_i32();
        r.get_i32();
        r.get_f32();
        for (int k = 0; k < 9; k++) r.get_f32();
        std::vector<float> frame;
        int na = 0;
        if (!decode_frame(r, frame, &na)) break;
        memcpy(out + (size_t)frames * na * 3, frame.data(), frame.size() * 4);
        frames++;
    }
    fclose(f);
    return frames;
}

int trajio_xtc_write(const char* path, const float* pos_nm, int n_frames, int n_atoms,
                     float precision) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    for (int fr = 0; fr < n_frames; fr++) {
        XdrWriter w{f};
        w.put_i32(kXtcMagic);
        w.put_i32(n_atoms);
        w.put_i32(fr);            // step
        w.put_f32((float)fr);     // time
        for (int k = 0; k < 9; k++) w.put_f32(0.0f);  // box
        if (!encode_frame(w, pos_nm + (size_t)fr * n_atoms * 3, n_atoms, precision) || !w.ok) {
            fclose(f);
            return -2;
        }
    }
    fclose(f);
    return 0;
}
}  // extern "C"
